"""Augmented-Lagrangian box constraints (twin of
`parallel_ddp_tpu/constraints.py`).

Inequality constraints c(x, u) <= 0 enter the stage cost as the PHR penalty

    phi(c; lam, mu) = lam c + (mu/2) c^2        if  lam + mu c > 0   (active)
                    = -lam^2 / (2 mu)           otherwise            (inactive)

with the multipliers updated between solves, lam <- max(0, lam + mu c).  The
multipliers and the penalty weight ride the goal pytree,
{"base": <the cost's goal>, "lam": (N, n_c), "mu": 0-d}, so on the card a
new lam or mu is data the solver's graph loads, never a new capture (the
reference keeps them traced for the same reason).  Box bounds have constant
+/-identity constraint Jacobians, so the penalty's exact gradient and Hessian
are diagonal adds, written directly.

As every cost of the port, `al_cost` works on whole trajectories: `k` is a
tensor of knot indices broadcast against the leading dims of x and u, and
`lam` is gathered per knot.  It is out-of-place, so it runs under
`torch.func.vmap` (per-scenario goals of a batched solve) and graph capture.

`solve_al` keeps the reference's outer loop on the host: one inner solve per
outer iteration (one graph replay on the card, warm-started from the last
solve's P, p and d), one host read of the violation after it;
`make_al_solver` keeps its inner solver, and so its graphs, across calls.
`ALMPCController` adds one multiplier update per control period around the
MPC step; on the card the shift, the budgeted solve and the update are one
graph replay with no host read.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from parallel_ddp_tpu_torch import graphs
from parallel_ddp_tpu_torch.config import CostWeights, SolverConfig, weights_of, weights_tensor
from parallel_ddp_tpu_torch.costs.base import CostModel
from parallel_ddp_tpu_torch.device import as_tensor, default_device
from parallel_ddp_tpu_torch.models.base import Plant
from parallel_ddp_tpu_torch.mpc.driver import (MPCConfig, MPCController, MPCState, _shift,
                                               device_scalar)
from parallel_ddp_tpu_torch.solver import make_ilqr_solver, refuse_tf32


@dataclasses.dataclass(frozen=True)
class BoxConstraints:
    """Component-wise bounds (float32 numpy arrays); None leaves that side
    unbounded.  u bounds apply at every non-terminal knot (the terminal
    control is never executed); x bounds at every knot.  The bounds become
    tensors once per device and dtype."""

    n_state: int
    n_ctrl: int
    u_min: Optional[np.ndarray] = None
    u_max: Optional[np.ndarray] = None
    x_min: Optional[np.ndarray] = None
    x_max: Optional[np.ndarray] = None

    def __post_init__(self):
        for name, v, d in (("u_min", self.u_min, self.n_ctrl),
                           ("u_max", self.u_max, self.n_ctrl),
                           ("x_min", self.x_min, self.n_state),
                           ("x_max", self.x_max, self.n_state)):
            if v is not None:
                object.__setattr__(self, name, np.asarray(v, np.float32).reshape(d))
        object.__setattr__(self, "_consts", {})

    @property
    def n_c(self) -> int:
        n = sum(self.n_ctrl for v in (self.u_min, self.u_max) if v is not None)
        n += sum(self.n_state for v in (self.x_min, self.x_max) if v is not None)
        if n == 0:
            raise ValueError("BoxConstraints with no bounds")
        return n

    def _groups(self):
        """(bound, sign, is_u) of each bound group, in the row order of c:
        u_min, u_max, x_min, x_max."""
        return [(b, s, is_u) for b, s, is_u in ((self.u_min, -1.0, True),
                                                (self.u_max, 1.0, True),
                                                (self.x_min, -1.0, False),
                                                (self.x_max, 1.0, False)) if b is not None]

    def _tensors(self, like: torch.Tensor):
        """The bounds as tensors on like's device and dtype (float32 beside
        bfloat16, as the JAX package's numpy bounds), made once: (column of
        [x; u] each row reads, its sign, its bound, whether it is a control
        row, u_min, u_max)."""
        key = (like.device, torch.promote_types(like.dtype, torch.float32))
        found = self._consts.get(key)
        if found is None:
            n = self.n_state
            rows = [(np.arange(len(b)) + (n if is_u else 0), np.full(len(b), s), b,
                     np.full(len(b), is_u)) for b, s, is_u in self._groups()]
            cols, signs, bounds, is_u = (np.concatenate(r) for r in zip(*rows))
            on = dict(device=like.device)
            f = dict(dtype=key[1], **on)
            found = self._consts[key] = (
                torch.as_tensor(cols, dtype=torch.int64, **on), torch.as_tensor(signs, **f),
                torch.as_tensor(bounds, **f), torch.as_tensor(is_u, **on),
                None if self.u_min is None else torch.as_tensor(self.u_min, **f),
                None if self.u_max is None else torch.as_tensor(self.u_max, **f))
        return found

    def residuals(self, x, u, terminal):
        """c (..., n_c) of x (..., n) and u (..., m): positive = violated.
        `terminal` (a bool, or a bool tensor broadcast against the leading
        dims) masks the control rows to 0 (the terminal control is never
        executed).  Each row is sign * (z - bound) over z = [x; u], which
        is the reference's u_min - u, u - u_max, x_min - x and x - x_max
        exactly (a - b = -(b - a) in IEEE arithmetic)."""
        cols, signs, bounds, is_u, _, _ = self._tensors(x)
        lead = torch.broadcast_shapes(x.shape[:-1], u.shape[:-1])
        z = torch.cat([x.expand(lead + x.shape[-1:]), u.expand(lead + u.shape[-1:])], dim=-1)
        c = signs * (z.index_select(-1, cols) - bounds)
        if isinstance(terminal, bool):
            return torch.where(is_u, 0.0, c) if terminal else c
        return torch.where(torch.logical_and(terminal[..., None], is_u), 0.0, c)

    def clip_u(self, u):
        """Hard-clip a control to the box: the execution-side guard the
        reference sketches (`clip`, MPCHelpers.cuh:473-501).  With the AL
        keeping the plan near-feasible this is a small correction."""
        _, _, _, _, lo, hi = self._tensors(u)
        if lo is not None:
            u = torch.maximum(u, lo)
        if hi is not None:
            u = torch.minimum(u, hi)
        return u

    def jac_blocks(self):
        """Rows of dc/d[x; u] as (sign, offset, width, is_u) per constraint
        group, in the row order of c."""
        n, m = self.n_state, self.n_ctrl
        return [(s, n if is_u else 0, m if is_u else n, is_u) for _, s, is_u in self._groups()]


def _phi(c, lam, mu):
    """PHR penalty, elementwise."""
    active = lam + mu * c > 0.0
    return torch.where(active, lam * c + 0.5 * mu * c * c, -(lam * lam) / (2.0 * mu))


def al_cost(base: CostModel, con: BoxConstraints, nf: int) -> CostModel:
    """Wrap a cost model with the AL penalty.  The wrapped goal pytree is
    {"base": <original goal>, "lam": (N, n_c), "mu": 0-d tensor}."""
    n = con.n_state

    def stage(x, u, k, goal, w):
        c = con.residuals(x, u, k == nf)
        return base.stage(x, u, k, goal["base"], w) + _phi(
            c, goal["lam"][..., k, :], goal["mu"]).sum(-1)

    def quad(x, u, k, goal, w):
        h, g = base.quad(x, u, k, goal["base"], w)
        mu = goal["mu"]
        terminal = k == nf
        c = con.residuals(x, u, terminal)
        dphi = torch.clamp(goal["lam"][..., k, :] + mu * c, min=0.0)    # d phi / d c
        active = (dphi > 0.0).to(x.dtype)
        # box rows: dc/dz = sign * e_i, so grad += sign * dphi and the Hessian
        # diagonal += mu * active (exact, not Gauss-Newton); each group added
        # in turn, as the reference's scatter-adds
        u_on = (~terminal).to(x.dtype)[..., None]
        g_parts = [g[..., :n], g[..., n:]]
        h_parts = list(torch.diagonal(h, dim1=-2, dim2=-1).split([n, g.shape[-1] - n], -1))
        off = 0
        for sign, _, width, is_u in con.jac_blocks():
            seg = slice(off, off + width)
            scale = u_on if is_u else 1.0
            g_parts[is_u] = g_parts[is_u] + sign * dphi[..., seg] * scale
            h_parts[is_u] = h_parts[is_u] + mu * active[..., seg] * scale
            off += width
        lead = torch.broadcast_shapes(*(p.shape[:-1] for p in g_parts + h_parts))
        cat = lambda parts: torch.cat([p.expand(lead + p.shape[-1:]) for p in parts], -1)
        diag = torch.diag_embed(cat(h_parts))
        eye = torch.eye(h.shape[-1], dtype=torch.bool, device=h.device)
        return torch.where(eye, diag, h), cat(g_parts)

    return CostModel(name=f"{base.name}_al", stage=stage, quad=quad)


@dataclasses.dataclass(frozen=True)
class ALConfig:
    max_outer: int = 10
    tol_violation: float = 1e-3
    mu_init: float = 10.0
    mu_factor: float = 5.0
    mu_max: float = 1e6
    lam_max: float = 1e6


def _update_lam(con: BoxConstraints, nf: int, lam, x, u, mu, lam_max):
    """The PHR multiplier update from a trajectory: (lam', c)."""
    ks = torch.arange(x.shape[-2], device=x.device)
    c = con.residuals(x, u, ks == nf)
    return torch.clamp(torch.clamp(lam + mu * c, min=0.0), 0.0, lam_max), c


class ALSolver:
    """The constrained solve for a (plant, cost, config, bounds, ALConfig):
    the outer multiplier loop around ONE inner solver (`self.solver`, the
    AL cost's), kept across calls, so on the card its two graphs (the cold
    solve's and the warm one's) are captured once and every inner solve of
    every call is a replay: lam and mu are goal leaves, data to the graph."""

    def __init__(self, plant: Plant, cost: CostModel, cfg: SolverConfig, con: BoxConstraints,
                 al: ALConfig = ALConfig()):
        self.cost, self.cfg, self.con, self.al = cost, cfg, con, al
        self.nf = cfg.num_time_steps - 1
        self.solver = make_ilqr_solver(plant, al_cost(cost, con, self.nf), cfg)

    def __call__(self, x0, u0, goal, weights: Optional[CostWeights] = None,
                 initial_rollout: bool = True, device=None):
        """x0 as a list or numpy array goes to `device` (default: the card);
        a tensor keeps its device.  Returns (out, info): out is the last
        inner `SolveOutput`; info holds the violation after each outer
        iteration (one host read each), the multipliers, mu, the outer count
        and the base cost of the final trajectory (one host read)."""
        cfg, con, al = self.cfg, self.con, self.al
        x_cur = as_tensor(x0, device=device)
        dev, dtype = x_cur.device, x_cur.dtype
        u_cur = torch.as_tensor(u0, dtype=dtype, device=dev)
        lam = torch.zeros((cfg.num_time_steps, con.n_c), dtype=dtype, device=dev)
        # mu is tracked on the host in float32 (the reference's arithmetic)
        # and written into a device scalar by a fill: no read of the device
        mu_host = np.float32(al.mu_init)
        mu = torch.full((), float(mu_host), dtype=dtype, device=dev)
        viols, out, warm, rollout = [], None, {}, initial_rollout
        for _ in range(al.max_outer):
            out = self.solver(x_cur, u_cur, {"base": goal, "lam": lam, "mu": mu}, weights,
                              initial_rollout=rollout, **warm)
            lam_next, c = _update_lam(con, self.nf, lam, out.x, out.u, mu, al.lam_max)
            viol = float(torch.clamp(c, min=0.0).max())
            viols.append(viol)
            if viol < al.tol_violation:
                break
            lam = lam_next
            mu_host = min(mu_host * np.float32(al.mu_factor), np.float32(al.mu_max))
            mu = torch.full((), float(mu_host), dtype=dtype, device=dev)
            # warm start from the whole solver state: x and u alone would zero
            # the multiple-shooting defects and the cost-to-go seeds
            x_cur, u_cur = out.x, out.u
            warm = {"P0": out.P, "p0": out.p, "d0": out.d}
            rollout = False
        # out.J holds the AL terms; the base cost of the final trajectory is
        # the number comparable to an unconstrained solve
        ks = torch.arange(cfg.num_time_steps, device=dev)
        base_J = float(self.cost.stage(out.x, out.u, ks, goal, weights_of(weights, out.x)).sum())
        info = {"violations": viols, "lam": lam, "mu": float(mu_host),
                "outer_iters": len(viols), "base_J": base_J}
        return out, info


def make_al_solver(plant: Plant, cost: CostModel, cfg: SolverConfig, con: BoxConstraints,
                   al: ALConfig = ALConfig()) -> ALSolver:
    """Build the constrained solve: solve(x0, u0, goal, weights=None,
    initial_rollout=True, device=None) -> (out, info), as `solve_al`."""
    return ALSolver(plant, cost, cfg, con, al)


def solve_al(plant: Plant, cost: CostModel, cfg: SolverConfig, x0, u0, goal,
             con: BoxConstraints, al: ALConfig = ALConfig(),
             weights: Optional[CostWeights] = None, initial_rollout: bool = True,
             device=None):
    """Constrained solve (the reference's entry point): outer multiplier
    updates around the inner iLQR solve.  One-shot wrapper of
    `make_al_solver`; see `ALSolver.__call__` for the arguments and the
    returned (out, info)."""
    return make_al_solver(plant, cost, cfg, con, al)(x0, u0, goal, weights, initial_rollout,
                                                     device=device)


class ALMPCController:
    """Real-time constrained MPC: the warm-started MPC driver with box bounds
    kept by a persistent augmented Lagrangian.  One multiplier update per
    control period (the solver is warm, so x, u and lam converge together
    across periods), the multipliers shifted with the horizon, mu fixed.
    Wraps `mpc.driver.MPCController` with `al_cost`: lam and mu ride its
    goal pytree.

    On the card a period (shift of lam, the budgeted MPC step, the PHR
    update) is one replay of a graph of its own (`graphs.GraphCache`): the
    MPC step's own graph cannot be nested in it, so this graph captures the
    step's body.  It reads nothing on the host, and goal, weights, state,
    lam and mu change without a new capture."""

    def __init__(self, plant: Plant, cost: CostModel, cfg: SolverConfig,
                 mpc_cfg: MPCConfig, con: BoxConstraints, mu: float = 50.0,
                 lam_max: float = 1e6):
        self.nf = cfg.num_time_steps - 1
        self.con = con
        self.cfg = cfg
        self.mu = float(np.float32(mu))
        self.lam_max = lam_max
        self.ctrl = MPCController(plant, al_cost(cost, con, self.nf), cfg, mpc_cfg)
        self.graphs = graphs.GraphCache("al_mpc_step")
        self._mu_on: dict = {}

    @property
    def host_syncs(self) -> int:
        """Host reads by the last period's solve (0 on the card)."""
        return self.ctrl.host_syncs

    def _mu_tensor(self, device) -> torch.Tensor:
        device = torch.device(device)
        if device not in self._mu_on:
            self._mu_on[device] = torch.full((), self.mu, dtype=torch.float32, device=device)
        return self._mu_on[device]

    def zero_lam(self, device=None) -> torch.Tensor:
        """(N, n_c) zeros on `device` (default: the card)."""
        return torch.zeros((self.cfg.num_time_steps, self.con.n_c),
                           device=default_device() if device is None else device)

    def wrap_goal(self, goal, lam, mu=None):
        return {"base": goal, "lam": lam,
                "mu": self._mu_tensor(lam.device) if mu is None else mu}

    def init_state(self, x_actual, t0: float = 0.0, goal=None,
                   weights: Optional[CostWeights] = None, lam=None, device=None, **kw):
        """Cold start (the MPC driver's, on the AL cost with lam, zeros by
        default).  Returns (state, lam)."""
        x = as_tensor(x_actual, dtype=torch.float32, device=device)
        lam = self.zero_lam(x.device) if lam is None else lam
        st = self.ctrl.init_state(x, t0=t0, goal=self.wrap_goal(goal, lam), weights=weights,
                                  **kw)
        return st, lam

    def shift_lam(self, lam, t0, t_now):
        """lam shifted with the horizon by the driver's own shift
        (`MPCController.shift_steps`), so the multipliers stay aligned with
        the shifted trajectory the solve sees."""
        return _shift(lam, self.ctrl.shift_steps(t0, t_now))

    def update_lam(self, lam, x, u, mu):
        """One PHR update from the new plan: max(0, lam + mu c), clipped."""
        return _update_lam(self.con, self.nf, lam, x, u, mu, self.lam_max)[0]

    def _al_step(self, st: MPCState, lam, x_actual, t_now, goal, weights, mu, iter_limit):
        """A period's body (what the card's graph captures)."""
        lam_s = self.shift_lam(lam, st.t0, t_now)
        st2, info = self.ctrl._mpc_step(st, x_actual, t_now, self.wrap_goal(goal, lam_s, mu),
                                        weights, iter_limit)
        return st2, self.update_lam(lam_s, st2.x, st2.u, mu), info

    def step(self, st: MPCState, lam, x_actual, t_now, goal,
             weights: Optional[CostWeights] = None, iter_limit: Optional[int] = None,
             time_limit_ms: Optional[float] = None):
        """One constrained MPC period: shift the multipliers with the
        horizon, budgeted solve, one PHR update from the new plan.
        Returns (state, lam, info)."""
        dev = st.x.device
        args = (st, lam, torch.as_tensor(x_actual, dtype=torch.float32, device=dev),
                device_scalar(t_now, dev), goal, weights_tensor(weights, dev),
                self._mu_tensor(dev), self.ctrl._resolve_iter_limit(iter_limit, time_limit_ms))
        if not graphs.replayed(dev):
            return self._al_step(*args)
        refuse_tf32(dev)
        graph = self.graphs.get(graphs.signature(args), self._al_step, args)
        out = graph(*args)
        self.ctrl._host_syncs = 0
        return out
