"""iLQR solve driver (twin of `parallel_ddp_tpu/solver.py`; DDPWrappers.cuh:8-138).

Each iteration is
  backward pass (with rho-retry)  ->  forward sweep + multiple-shooting rollout +
  parallel line search  ->  accept/reject + rho schedule  ->  next-iteration
  derivative recompute,
all on the device of the tensors passed in (an x0 given as a list or numpy
array goes to the card, `device.default_device()`, unless the call names a
`device`).  Like the reference package's `lax.while_loop`, the iteration is
one body (`_Solver._iteration`) that commits every result under
active = ~done & (it <= cap), so it can run past the end of a solve and
change nothing.  The body works on a batch of B independent scenarios (the
reference's `jax.vmap` over its while_loop): every field of the carry has a
leading scenario axis, each scenario commits under its own active flag, and
the loop runs while any scenario is active.  A single solve is the same body
at B = 1, the axis added and taken off at the entry point.  Two loops run it:
  * on the CPU, a host loop that reads the exit flag once per iteration but
    the last one the budget allows, plus once per rho attempt inside the
    backward pass (`solver.host_syncs` holds the count of the last solve);
  * on the card, one replay of a CUDA graph (`graphs.py`) in which the
    iterations and the rho retry are WHILE nodes: the host reads nothing,
    and `host_syncs` is 0.
Exit conditions match acceptRejectTraj* (nisInitHelpers.cuh:487-592).

Reduced precision (`SolverConfig.bf16_rollout`, `bf16_cost`; the JAX
package's solver.py:122-141, 177-183): the line search's forward simulation
steps in bfloat16 (`ops/integrators.py::make_bf16_step`, or the plant's
`fused_rollout_bf16` op, never its float32 `fused_rollout`), and each stage
cost is evaluated on bfloat16 x and u and handed back in the solve's dtype,
so every sum over stages and alphas accumulates there; J0 goes through the
same stage.  The feedback law, the open-loop rollout, the derivative stage
and the backward pass stay in the solve's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils import _pytree as pytree

from parallel_ddp_tpu_torch import graphs
from parallel_ddp_tpu_torch.config import (CostWeights, SolveOutput, SolverConfig, weights_of,
                                           weights_tensor)
from parallel_ddp_tpu_torch.costs.base import CostModel
from parallel_ddp_tpu_torch.device import as_tensor
from parallel_ddp_tpu_torch.models.base import Plant
from parallel_ddp_tpu_torch.ops.cuda_sim_chain import make_sim_chain
from parallel_ddp_tpu_torch.ops.integrators import (make_bf16_step, make_step,
                                                    make_step_jacobian, make_step_jacobian_fd)
from parallel_ddp_tpu_torch.parallel.backward import backward_pass, per_scenario_mask
from parallel_ddp_tpu_torch.parallel.forward import forward_pass, line_search


def goal_dims(goal):
    """The vmap in_dims of a batch's goal pytree: the leading axis of every
    tensor leaf (an `x_target` may be per knot, (B, N, n): no leaf is
    reshaped)."""
    return pytree.tree_map(lambda leaf: 0 if isinstance(leaf, torch.Tensor) else None, goal)


def per_scenario(fn, dims):
    """A cost function fn(x, u, k, goal, w) over x and u with a leading
    scenario axis: one call when every scenario shares the goal (dims None;
    the costs take any leading dims), else `torch.func.vmap` over the goal's
    leading axis too (dims from `goal_dims`)."""
    if dims is None:
        return fn
    return torch.func.vmap(fn, in_dims=(0, 0, None, dims, None))


def _derivatives(cfg, step_jac, cost_quad, x, u, goal, w, ks=None):
    """Next-iteration setup: AB/H/g at the accepted trajectory over the whole
    time axis (integratorGradientKern + costGradientHessianKern,
    nisInitHelpers.cuh:245-279), for x (..., N, n): the leading scenario
    dims are flattened into the dynamics' sample axis.  AB has N-1 rows.

    With `ks`, x (..., Nl, n) is a chunk of the horizon whose knots have the
    global step indices ks (broadcast against x's leading dims; the 'sp'
    path, `parallel/sp.py`): AB then has a row at every knot, zero at the
    global k = N-1, the row the single solve pads.

    `step_jac` is either a per-sample jac (vmapped here) or an already-batched
    (S, n)-in (S, n, n+m)-out function (Plant.batched_step_jac — the
    RBD-Jacobian op on the main path — or the finite-difference AB),
    marked with `_is_batched`."""
    n, m = x.shape[-1], u.shape[-1]
    xs, us = (x, u) if ks is not None else (x[..., :-1, :], u[..., :-1, :])
    if getattr(step_jac, "_is_batched", False):
        AB = step_jac(xs.reshape(-1, n), us.reshape(-1, m))
    else:
        AB = torch.func.vmap(step_jac)(xs.reshape(-1, n), us.reshape(-1, m))
    AB = AB.reshape(xs.shape[:-1] + AB.shape[-2:])
    if ks is None:
        ks = torch.arange(cfg.num_time_steps, device=x.device)
    else:
        AB = torch.where((ks == cfg.num_time_steps - 1)[..., None, None], torch.zeros_like(AB),
                         AB)
    H, g = cost_quad(x, u, ks, goal, w)
    return AB, H, g


def open_loop_rollout(cfg: SolverConfig, open_loop, x0_state, u):
    """Multiple-shooting open-loop rollout from the block-start states in
    x0_state (..., N, n) (the initial `forwardSimKern` rollout,
    nisInitHelpers.cuh:643): every block's Nf steps as one call of
    `open_loop`, a `SimChain.open_loop` (`make_sim_chain(plant, integrator,
    dt).open_loop`).  Returns (x, d)."""
    N, M, Nf = cfg.num_time_steps, cfg.m_blocks_f, cfg.n_blocks_f
    lead, n = x0_state.shape[:-2], x0_state.shape[-1]
    x_blk = x0_state.reshape(lead + (M, Nf, n))
    u_blk = u.reshape(lead + (M, Nf, u.shape[-1]))
    x_next = open_loop(x_blk[..., 0, :], u_blk)                      # (..., M, Nf, n)
    x_new = torch.cat([x_blk[..., :1, :], x_next[..., :-1, :]], dim=-2).reshape(lead + (N, n))
    d = x0_state.new_zeros(lead + (N, n))
    if M > 1:
        d[..., Nf - 1:N - 1:Nf, :] = x_next[..., :-1, -1, :] - x_blk[..., 1:, 0, :]
    return x_new, d


def bf16_stage(stage):
    """A stage cost fn(x, u, k, goal, w) evaluated on bfloat16 x and u and
    handed back in x's dtype (`SolverConfig.bf16_cost`)."""

    def stage_bf16(x, u, k, goal, w):
        return stage(x.to(torch.bfloat16), u.to(torch.bfloat16), k, goal, w).to(x.dtype)

    return stage_bf16


def refuse_tf32(device: torch.device) -> None:
    """Raise on the card when TF32 matmuls are on: TF32 keeps ~3 decimal
    digits, Huu turns indefinite and the Riccati recursion fails (the
    reference pins "highest" precision)."""
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True; the Riccati and "
            "RBD math needs full float32 matmuls")


class _Carry:
    """The solve's state across iterations: the reference's `_Carry`, held in
    tensors that `_iteration` updates in place (a captured loop body can
    only hand its results on through memory written before the loop).
    Every field has a leading scenario axis B.  AB/H/g are not carried: each
    iteration computes them first.  The reference's xp is always x, and its
    Pp/pp always P/p.  `goal_dims` says how the goal maps onto the scenarios
    (`per_scenario`)."""

    FIELDS = ("x", "u", "d", "xp2", "P", "p", "K", "du", "prevJ", "rho", "drho",
              "ignore_defect", "it", "done", "converged", "feasible", "J_trace",
              "alpha_trace", "defect_trace", "max_defect")

    def __init__(self, goal_dims=None, **fields):
        self.goal_dims = goal_dims
        for name in self.FIELDS:
            setattr(self, name, fields[name])

    def commit(self, name, where, value):
        """field[b] <- value[b] where where[b] (in place)."""
        held = getattr(self, name)
        held.copy_(torch.where(per_scenario_mask(where, held), value, held))

    def record(self, name, where, value):
        """trace[b, it[b]] <- value[b] where where[b] (in place, at the device
        index it, clamped to the trace so a spent solve writes nothing)."""
        trace = getattr(self, name)
        idx = torch.clamp(self.it, max=trace.shape[-1] - 1).to(torch.int64)[:, None]
        held = trace.gather(1, idx)
        trace.scatter_(1, idx, torch.where(where[:, None], value[:, None].to(trace.dtype), held))


class _Solver:
    """The solve function for one (plant, cost, config) triple.

    A call solves one problem, `solve_batch` B of them; both run the same
    batched body.  On the CPU a call runs `_init_carry`, then `_iteration`
    in a host loop that reads the exit flag once per iteration but the
    last.  On the card a call replays a CUDA graph (`graphs.py`) that holds
    the same body in a WHILE node; it is captured once per static signature
    (shapes, dtype, the two flags, which of P0/p0/d0 are given and the
    goal's structure).  The cost weights are a device tensor of the graph,
    loaded like the goal, and so is the iteration cap: a new weight value,
    goal or `iter_limit` needs no new capture."""

    def __init__(self, plant: Plant, cost: CostModel, cfg: SolverConfig):
        self.plant, self.cost, self.cfg = plant, cost, cfg
        self.step_fn = make_step(plant, cfg.integrator, cfg.dt)
        # the line search's step and the stage cost (bfloat16 where asked)
        self.step_fwd = make_bf16_step(self.step_fn) if cfg.bf16_rollout else self.step_fn
        self.stage = bf16_stage(cost.stage) if cfg.bf16_cost else cost.stage
        self.chain = make_sim_chain(plant, cfg.integrator, cfg.dt)
        if cfg.use_finite_diff:
            self.step_jac = make_step_jacobian_fd(plant, cfg.integrator, cfg.dt, cfg.fd_eps)
        elif plant.batched_step_jac is not None:
            self.step_jac = plant.batched_step_jac(cfg.integrator, cfg.dt)
            self.step_jac._is_batched = True
        else:
            self.step_jac = make_step_jacobian(plant, cfg.integrator, cfg.dt)
        # the whole forward simulation in one op when the plant ships one
        # (under bf16_rollout its bfloat16 op: the float32 one is never asked)
        fused = plant.fused_rollout_bf16 if cfg.bf16_rollout else plant.fused_rollout
        self.fused_sim = None
        if fused is not None and not cfg.slq:
            self.fused_sim = fused(cfg.integrator, cfg.dt, cfg.num_time_steps, cfg.m_blocks_f,
                                   cfg.num_alpha)
        self._alphas = {}
        self.graphs = graphs.GraphCache("solve")
        self.host_syncs = 0

    def alphas(self, device, dtype) -> torch.Tensor:
        key = (device, dtype)
        if key not in self._alphas:
            self._alphas[key] = torch.as_tensor(self.cfg.alphas(), dtype=dtype, device=device)
        return self._alphas[key]

    def __call__(
        self,
        x0,
        u0,
        goal,
        weights: Optional[CostWeights] = None,
        P0=None,
        p0=None,
        d0=None,
        initial_rollout: bool = False,
        ignore_first_defect: bool = False,
        iter_limit: Optional[int] = None,
        device=None,
    ) -> SolveOutput:
        """One solve: x0 (N, n), u0 (N, m), P0/p0/d0 (N, ...)."""
        return self._entry(False, x0, u0, goal, weights, P0, p0, d0, initial_rollout,
                           ignore_first_defect, iter_limit, device)

    def solve_batch(
        self,
        x0s,
        u0s,
        goals,
        weights: Optional[CostWeights] = None,
        P0=None,
        p0=None,
        d0=None,
        initial_rollout: bool = False,
        ignore_first_defect: bool = False,
        iter_limit: Optional[int] = None,
        device=None,
    ) -> SolveOutput:
        """B independent solves at once: x0s (B, N, n), u0s (B, N, m),
        P0/p0/d0 (B, ...), goals a pytree whose tensors have a leading B;
        the weights and the iteration cap are shared.  Every leaf of the
        output has a leading B."""
        return self._entry(True, x0s, u0s, goals, weights, P0, p0, d0,
                           initial_rollout, ignore_first_defect, iter_limit, device)

    def _entry(self, batched: bool, x0, u0, goal, weights, P0, p0, d0, initial_rollout,
               ignore_first_defect, iter_limit, device) -> SolveOutput:
        cfg = self.cfg
        x0 = as_tensor(x0, device=device)
        dtype, device = x0.dtype, x0.device
        refuse_tf32(device)
        u0 = torch.as_tensor(u0, dtype=dtype, device=device)
        if x0.dim() != 2 + batched:
            raise ValueError(f"x0 must have {2 + batched} dims, got shape {tuple(x0.shape)}")
        run = self.run_batch if batched else self.run
        w = weights_tensor(weights, device, dtype)
        it_cap = cfg.max_iter if iter_limit is None else min(max(int(iter_limit), 1), cfg.max_iter)
        flags = (bool(initial_rollout), bool(ignore_first_defect))
        args = (x0, u0, goal, P0, p0, d0, it_cap, w)
        if not self._replayed(device):
            out, self.host_syncs = run(*args, *flags)
            return out
        fn = lambda *a: run(*a, *flags)[0]
        graph = self.graphs.get(graphs.signature(args, flags), fn, args)
        out = graph(*args)
        self.host_syncs = 0
        return out

    def _replayed(self, device) -> bool:
        """Whether a call on device replays a graph (`graphs.replayed`)."""
        return graphs.replayed(device)

    def run(self, x0, u0, goal, P0, p0, d0, it_cap, w, initial_rollout: bool,
            ignore_first_defect: bool):
        """One solve on the device of x0 (the body the card's graphs
        capture): the batched body at B = 1 with the goal shared.  Returns
        (SolveOutput, host reads of device values).  it_cap: the iteration
        cap, an int or a 0-d integer tensor; w: the weights (a (21,) tensor
        or a `CostWeights`)."""
        one = lambda t: None if t is None else t[None]
        out, syncs = self.run_batch(one(x0), one(u0), goal, one(P0), one(p0), one(d0), it_cap,
                                    w, initial_rollout, ignore_first_defect, shared_goal=True)
        return SolveOutput(*(t[0] for t in out)), syncs

    def run_batch(self, x0, u0, goal, P0, p0, d0, it_cap, w, initial_rollout: bool,
                  ignore_first_defect: bool, shared_goal: bool = False):
        """B solves on the device of x0 (B, N, n): returns (SolveOutput with
        a leading B on every leaf, host reads).  shared_goal: one goal for
        every scenario, else its tensors have a leading B."""
        c = self._init_carry(x0, u0, goal, w, P0, p0, d0, initial_rollout, ignore_first_defect,
                             shared_goal)
        syncs = self._drive(c, goal, w, it_cap)
        return SolveOutput(
            x=c.x, u=c.u, K=c.K, d=c.d, P=c.P, p=c.p, J=c.prevJ, iters=c.it - 1,
            J_trace=c.J_trace, alpha_trace=c.alpha_trace, rho=c.rho,
            max_defect=c.max_defect, converged=c.converged, last_feasible=c.feasible,
            defect_trace=c.defect_trace,
        ), syncs

    def _drive(self, c: _Carry, goal, w, it_cap) -> int:
        """Run the iterations on c; returns the host reads made."""
        if isinstance(it_cap, torch.Tensor) or graphs.capturing(c.x) or graphs.in_masked():
            # the graph's loop (a WHILE node) and the masked one (graphs.py):
            # while any scenario is active
            return graphs.while_loop(
                lambda: torch.logical_and(~c.done, c.it <= it_cap).any(),
                lambda go: self._iteration(c, goal, w, it_cap), self.cfg.max_iter)
        # the CPU's: one read of the exit flag per iteration, none after the
        # iteration the budget ends (a scenario that is not done has run
        # every iteration so far, so the cap binds them all at once)
        cap = torch.full((), it_cap, dtype=torch.int32, device=c.x.device)
        syncs = 0
        for it in range(1, it_cap + 1):
            syncs += self._iteration(c, goal, w, cap)
            if it == it_cap:
                break
            syncs += 1
            if bool(c.done.all()):
                break
        return syncs

    def _open_loop(self, x0, u0):
        """The cold start's multiple-shooting rollout of x0, u0 (B, N, ...):
        (x, d)."""
        return open_loop_rollout(self.cfg, self.chain.open_loop, x0, u0)

    def _total_cost(self, stage, x, u):
        """Each trajectory's cost, stage(x, u, k) summed over the time axis:
        x (..., N, n) -> (...)."""
        return stage(x, u, torch.arange(x.shape[-2], device=x.device)).sum(-1)

    def _defect_norm(self, d):
        """The defect metric of each scenario (defectKern,
        fpHelpers.cuh:94-111): the largest L1 norm over d's knots, (B,)."""
        return d.abs().sum(-1).amax(-1)

    def _passes(self, c: _Carry, goal, w, stage, alphas):
        """One iteration's derivative stage, backward pass (with rho retry)
        and forward pass at c's trajectory: (BackwardPassResult,
        RolloutResult)."""
        cfg = self.cfg
        # derivatives at the accepted trajectory (nextIterationSetupGPU,
        # which runs on accept or reject)
        AB, H, g = _derivatives(cfg, self.step_jac, per_scenario(self.cost.quad, c.goal_dims),
                                c.x, c.u, goal, w)

        # BACKWARD PASS (with rho retry) ---------------------------------------
        bp = backward_pass(cfg, AB, H, g, c.P, c.p, c.d, c.x, c.xp2, c.rho, c.drho)

        # FORWARD PASS ----------------------------------------------------------
        ro = forward_pass(cfg, self.step_fwd, stage, c.x, c.u, c.d, bp.K, bp.du,
                          bp.ApBK, bp.Bdu, c.x, alphas, fused_sim=self.fused_sim)
        return bp, ro

    def _init_carry(self, x0, u0, goal, w, P0, p0, d0, initial_rollout, ignore_first_defect,
                    shared_goal: bool = False):
        """The state before the first iteration (fresh tensors: the caller's
        are never written).  x0 (B, N, n), or (N, n) for one problem (B = 1,
        the goal shared)."""
        if x0.dim() == 2:
            one = lambda t: None if t is None else t[None]
            x0, u0, P0, p0, d0 = (one(t) for t in (x0, u0, P0, p0, d0))
            shared_goal = True
        cfg = self.cfg
        N = x0.shape[1]
        B = x0.shape[0]
        n, m = self.plant.n_state, self.plant.n_ctrl
        dtype, device = x0.dtype, x0.device
        zeros = lambda *shape: torch.zeros((B,) + shape, dtype=dtype, device=device)
        full = lambda value, dt=dtype: torch.full((B,), value, dtype=dt, device=device)
        dims = None if shared_goal else goal_dims(goal)
        if initial_rollout:
            x, d = self._open_loop(x0, u0)
        else:
            x = x0.clone()
            d = d0.clone() if d0 is not None else zeros(N, n)
        u = u0.clone()
        stage = per_scenario(self.stage, dims)
        J0 = self._total_cost(lambda xk, uk, k: stage(xk, uk, k, goal, weights_of(w, x)), x, u)
        J_trace = torch.full((B, cfg.max_iter + 1), torch.nan, dtype=dtype, device=device)
        J_trace[:, 0] = J0
        alpha_trace = torch.full((B, cfg.max_iter + 1), -2, dtype=torch.int32, device=device)
        # fill_, not item assignment: assigning a Python int copies it from the
        # host and synchronises the stream
        alpha_trace[:, :1].fill_(0 if initial_rollout else -1)
        defect_trace = torch.full((B, cfg.max_iter + 1), torch.nan, dtype=dtype, device=device)
        defect_trace[:, 0] = self._defect_norm(d)
        return _Carry(
            goal_dims=dims,
            x=x, u=u, d=d, xp2=x.clone(),
            P=P0.clone() if P0 is not None else zeros(N, n, n),
            p=p0.clone() if p0 is not None else zeros(N, n),
            K=zeros(N, m, n), du=zeros(N, m),
            # epsilon bump so a zero first update does not instantly
            # "converge" (initAlgGPU, nisInitHelpers.cuh:392-395)
            prevJ=J0 + 2.0 * cfg.tol_cost,
            rho=full(cfg.rho_init), drho=full(1.0),
            ignore_defect=full(bool(ignore_first_defect), torch.bool),
            it=full(1, torch.int32), done=full(False, torch.bool),
            converged=full(False, torch.bool), feasible=full(True, torch.bool),
            J_trace=J_trace, alpha_trace=alpha_trace, defect_trace=defect_trace,
            max_defect=full(0.0),
        )

    def _iteration(self, c: _Carry, goal, w, cap) -> int:
        """One iteration of every scenario, each field of scenario b
        committed under active[b] = ~done[b] & (it[b] <= cap): run past the
        end of a scenario's solve it changes nothing there.  Returns the
        host reads made (the rho retry's, on the CPU)."""
        cfg = self.cfg
        active = torch.logical_and(~c.done, c.it <= cap)
        w = weights_of(w, c.x)
        cost_stage = per_scenario(self.stage, c.goal_dims)

        def stage(xk, uk, k):
            return cost_stage(xk, uk, k, goal, w)

        alphas = self.alphas(c.x.device, c.x.dtype)
        bp, ro = self._passes(c, goal, w, stage, alphas)
        ls = line_search(cfg, ro.J, ro.max_defect, alphas, bp.dJexp, c.prevJ,
                         c.ignore_defect)

        # ACCEPT / REJECT + rho schedule (acceptRejectTrajGPU,
        # nisInitHelpers.cuh:487-518) ---------------------------------------------
        accept = torch.logical_and(ls.accept, ~bp.fail)
        take = torch.logical_and(active, accept)
        sel = ls.alpha_idx
        # each scenario's candidate at its selected alpha (axis 1)
        pick = lambda a: torch.take_along_dim(a, per_scenario_mask(sel[:, None], a), dim=1)[:, 0]
        f = cfg.rho_factor
        drho_acc = torch.clamp(bp.drho / f, max=1.0 / f)
        rho_acc = torch.clamp(bp.rho * drho_acc, min=cfg.rho_min)
        drho_rej = torch.clamp(bp.drho * f, min=f)
        rho_rej = torch.clamp(bp.rho * drho_rej, max=cfg.rho_max)
        rho_new = torch.where(accept, rho_acc, rho_rej)
        dJ_frac = ls.dJ / c.prevJ

        # "converged": an accepted step improved by less than tol, or a
        # rejected step where even the best candidate had nothing to gain
        converged = torch.where(accept, dJ_frac < cfg.tol_cost,
                                ls.best_dJ_frac.abs() < cfg.tol_cost)
        done = torch.logical_and(accept, dJ_frac < cfg.tol_cost)
        if not cfg.ignore_max_rho_exit:
            done = done | (~accept & (rho_new >= cfg.rho_max))
        done = done | bp.fail

        c.record("J_trace", active, torch.where(accept, ls.J, c.prevJ))
        c.record("alpha_trace", active, torch.where(accept, sel, -1))
        c.record("defect_trace", active,
                 self._defect_norm(torch.where(per_scenario_mask(accept, c.d), pick(ro.d), c.d)))
        c.commit("xp2", active, c.x)
        c.commit("x", take, pick(ro.x))
        c.commit("u", take, pick(ro.u))
        c.commit("d", take, pick(ro.d))
        for name in ("P", "p", "K", "du"):
            c.commit(name, active, getattr(bp, name))
        c.commit("prevJ", take, ls.J)
        c.commit("max_defect", take, ls.max_defect)
        c.commit("rho", active, rho_new)
        c.commit("drho", active, torch.where(accept, drho_acc, drho_rej))
        c.commit("ignore_defect", active, ls.ignore_defect)
        c.commit("feasible", active, ls.any_feasible)
        c.commit("converged", active, converged)
        c.commit("done", active, done)
        c.it.add_(active.to(torch.int32))
        return bp.host_syncs


def make_ilqr_solver(plant: Plant, cost: CostModel, cfg: SolverConfig) -> _Solver:
    """Build the solve function for a (plant, cost, config) triple.

    Returns solve(x0, u0, goal, weights=None, *, P0=None, p0=None, d0=None,
                  initial_rollout=False, ignore_first_defect=False,
                  iter_limit=None, device=None) -> SolveOutput;
    `solve.solve_batch` takes the same arguments with a leading scenario
    axis (`parallel/sharding.py::make_batched_solver` wraps it)."""
    return _Solver(plant, cost, cfg)


def ilqr_solve(
    plant: Plant,
    cost: CostModel,
    cfg: SolverConfig,
    x0,
    u0,
    goal,
    weights: Optional[CostWeights] = None,
    **kwargs,
) -> SolveOutput:
    """One-shot convenience wrapper around `make_ilqr_solver`."""
    return make_ilqr_solver(plant, cost, cfg)(x0, u0, goal, weights, **kwargs)
