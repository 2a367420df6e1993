"""iLQR solve driver (twin of `parallel_ddp_tpu/solver.py`; DDPWrappers.cuh:8-138).

Each iteration is
  backward pass (with rho-retry)  ->  forward sweep + multiple-shooting rollout +
  parallel line search  ->  accept/reject + rho schedule  ->  next-iteration
  derivative recompute,
all on the device of the tensors passed in.  The reference package's
`lax.while_loop` becomes a Python `while` loop that reads its exit flag on the
host: one device sync per iteration (none after the last one allowed by the
iteration budget), plus one per rho attempt inside the backward pass.
`solver.host_syncs` holds the count of the last solve.  Exit conditions match
acceptRejectTraj* (nisInitHelpers.cuh:487-592).
"""

from __future__ import annotations

from typing import Optional

import torch

from parallel_ddp_tpu_torch.config import CostWeights, SolveOutput, SolverConfig
from parallel_ddp_tpu_torch.costs.base import CostModel
from parallel_ddp_tpu_torch.models.base import Plant
from parallel_ddp_tpu_torch.ops.integrators import make_step, make_step_jacobian
from parallel_ddp_tpu_torch.parallel.backward import backward_pass
from parallel_ddp_tpu_torch.parallel.forward import forward_pass, line_search


def _derivatives(cfg, step_jac, cost_quad, x, u, goal, w):
    """Next-iteration setup: AB/H/g at the accepted trajectory over the whole
    time axis (integratorGradientKern + costGradientHessianKern,
    nisInitHelpers.cuh:245-279).

    `step_jac` is either a per-sample jac (vmapped here) or an already-batched
    (N-1, n)-in (N-1, n, n+m)-out function (Plant.batched_step_jac — the
    RBD-Jacobian op on the main path), marked with `_is_batched`."""
    if getattr(step_jac, "_is_batched", False):
        AB = step_jac(x[:-1], u[:-1])
    else:
        AB = torch.func.vmap(step_jac)(x[:-1], u[:-1])
    ks = torch.arange(cfg.num_time_steps, device=x.device)
    H, g = cost_quad(x, u, ks, goal, w)
    return AB, H, g


def open_loop_rollout(cfg: SolverConfig, step_fn, x0_state, u):
    """Multiple-shooting open-loop rollout from the block-start states in
    x0_state (the initial `forwardSimKern` rollout, nisInitHelpers.cuh:643).
    Returns (x, d)."""
    N, M, Nf = cfg.num_time_steps, cfg.m_blocks_f, cfg.n_blocks_f
    n = x0_state.shape[-1]
    x_blk = x0_state.reshape(M, Nf, n)
    u_blk = u.reshape(M, Nf, -1)
    xc = x_blk[:, 0]
    xs = []
    for t in range(Nf):
        xc = step_fn(xc, u_blk[:, t])
        xs.append(xc)
    x_next = torch.stack(xs, dim=1)                                # (M, Nf, n)
    x_new = torch.cat([x_blk[:, :1], x_next[:, :-1]], dim=1).reshape(N, n)
    d = torch.zeros((N, n), dtype=x0_state.dtype, device=x0_state.device)
    if M > 1:
        d[Nf - 1:N - 1:Nf] = x_next[:-1, -1] - x_blk[1:, 0]
    return x_new, d


class _Solver:
    """The solve function for one (plant, cost, config) triple."""

    def __init__(self, plant: Plant, cost: CostModel, cfg: SolverConfig):
        unported = [f for f in ("use_finite_diff", "bf16_rollout", "bf16_cost",
                                "bp_assoc_scan") if getattr(cfg, f)]
        if unported:
            raise NotImplementedError(f"not ported yet: {', '.join(unported)}")
        self.plant, self.cost, self.cfg = plant, cost, cfg
        self.step_fn = make_step(plant, cfg.integrator, cfg.dt)
        if plant.batched_step_jac is not None:
            self.step_jac = plant.batched_step_jac(cfg.integrator, cfg.dt)
            self.step_jac._is_batched = True
        else:
            self.step_jac = make_step_jacobian(plant, cfg.integrator, cfg.dt)
        # the whole forward simulation in one op when the plant ships one
        self.fused_sim = None
        if plant.fused_rollout is not None and not cfg.slq:
            self.fused_sim = plant.fused_rollout(
                cfg.integrator, cfg.dt, cfg.num_time_steps, cfg.m_blocks_f,
                cfg.num_alpha)
        self._alphas = {}
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
    ) -> SolveOutput:
        cfg, cost, plant = self.cfg, self.cost, self.plant
        x0 = torch.as_tensor(x0)
        dtype, device = x0.dtype, x0.device
        if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
            # TF32 keeps ~3 decimal digits: Huu turns indefinite and the
            # Riccati recursion fails (the reference pins "highest" precision)
            raise RuntimeError(
                "torch.backends.cuda.matmul.allow_tf32 is True; the Riccati and "
                "RBD math needs full float32 matmuls")
        u0 = torch.as_tensor(u0, dtype=dtype, device=device)
        w = weights if weights is not None else CostWeights()
        N = cfg.num_time_steps
        n, m = plant.n_state, plant.n_ctrl
        it_cap = cfg.max_iter if iter_limit is None else min(max(int(iter_limit), 1), cfg.max_iter)
        alphas = self.alphas(device, dtype)
        zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
        full = lambda value, dt=dtype: torch.full((), value, dtype=dt, device=device)

        def stage(xk, uk, k):
            return cost.stage(xk, uk, k, goal, w)

        if initial_rollout:
            x, d = open_loop_rollout(cfg, self.step_fn, x0, u0)
        else:
            x = x0
            d = d0 if d0 is not None else zeros(N, n)
        u = u0
        P = Pp = P0 if P0 is not None else zeros(N, n, n)
        p = pp = p0 if p0 is not None else zeros(N, n)
        K, du = zeros(N, m, n), zeros(N, m)
        xp = xp2 = x

        AB, H, g = _derivatives(cfg, self.step_jac, cost.quad, x, u, goal, w)
        J0 = stage(x, u, torch.arange(N, device=device)).sum()
        # epsilon bump so a zero first update does not instantly "converge"
        # (initAlgGPU, nisInitHelpers.cuh:392-395)
        prevJ = J0 + 2.0 * cfg.tol_cost

        J_trace = torch.full((cfg.max_iter + 1,), torch.nan, dtype=dtype, device=device)
        J_trace[0] = J0
        alpha_trace = torch.full((cfg.max_iter + 1,), -2, dtype=torch.int32, device=device)
        # fill_, not item assignment: assigning a Python int copies it from the
        # host and synchronises the stream
        alpha_trace[:1].fill_(0 if initial_rollout else -1)
        defect_trace = torch.full((cfg.max_iter + 1,), torch.nan, dtype=dtype, device=device)
        defect_trace[0] = d.abs().sum(-1).amax()

        rho, drho = full(cfg.rho_init), full(1.0)
        ignore_defect = full(bool(ignore_first_defect), torch.bool)
        converged, feasible = full(False, torch.bool), full(True, torch.bool)
        max_defect = full(0.0)
        f = cfg.rho_factor
        it = 1
        syncs = 0
        while True:
            # BACKWARD PASS (with rho retry) -----------------------------------
            bp = backward_pass(cfg, AB, H, g, Pp, pp, d, x, xp2, rho, drho)
            syncs += bp.host_syncs

            # FORWARD PASS ------------------------------------------------------
            ro = forward_pass(cfg, self.step_fn, stage, x, u, d, bp.K, bp.du,
                              bp.ApBK, bp.Bdu, xp, alphas, fused_sim=self.fused_sim)
            ls = line_search(cfg, ro.J, ro.max_defect, alphas, bp.dJexp, prevJ,
                             ignore_defect)

            # ACCEPT / REJECT + rho schedule (acceptRejectTrajGPU,
            # nisInitHelpers.cuh:487-518) ---------------------------------------
            accept = torch.logical_and(ls.accept, ~bp.fail)
            pick = lambda a: a.index_select(0, ls.alpha_idx.reshape(1))[0]
            x_new = torch.where(accept, pick(ro.x), x)
            u_new = torch.where(accept, pick(ro.u), u)
            d_new = torch.where(accept, pick(ro.d), d)

            drho_acc = torch.clamp(bp.drho / f, max=1.0 / f)
            rho_acc = torch.clamp(bp.rho * drho_acc, min=cfg.rho_min)
            drho_rej = torch.clamp(bp.drho * f, min=f)
            rho_rej = torch.clamp(bp.rho * drho_rej, max=cfg.rho_max)
            rho_new = torch.where(accept, rho_acc, rho_rej)
            drho = torch.where(accept, drho_acc, drho_rej)

            dJ_frac = ls.dJ / prevJ
            J_trace[it] = torch.where(accept, ls.J, prevJ)
            alpha_trace[it] = torch.where(accept, ls.alpha_idx, -1)
            defect_trace[it] = d_new.abs().sum(-1).amax()

            # "converged": an accepted step improved by less than tol, or a
            # rejected step where even the best candidate had nothing to gain
            converged = torch.where(accept, dJ_frac < cfg.tol_cost,
                                    ls.best_dJ_frac.abs() < cfg.tol_cost)
            done = torch.logical_and(accept, dJ_frac < cfg.tol_cost)
            if not cfg.ignore_max_rho_exit:
                done = done | (~accept & (rho_new >= cfg.rho_max))
            done = done | bp.fail

            prevJ = torch.where(accept, ls.J, prevJ)
            max_defect = torch.where(accept, ls.max_defect, max_defect)
            ignore_defect, feasible = ls.ignore_defect, ls.any_feasible
            xp2, xp = xp, x_new
            x, u, d = x_new, u_new, d_new
            Pp, pp = P, p = bp.P, bp.p
            K, du = bp.K, bp.du
            rho = rho_new
            if it >= it_cap:      # the budget ends the solve: no sync needed
                break
            # NEXT ITERATION SETUP (runs on accept or reject, like the
            # reference's nextIterationSetupGPU), then the exit test
            AB, H, g = _derivatives(cfg, self.step_jac, cost.quad, x, u, goal, w)
            syncs += 1
            if bool(done):
                break
            it += 1
        self.host_syncs = syncs

        return SolveOutput(
            x=x, u=u, K=K, d=d, P=P, p=p, J=prevJ, iters=it,
            J_trace=J_trace, alpha_trace=alpha_trace, rho=rho,
            max_defect=max_defect, converged=converged, last_feasible=feasible,
            defect_trace=defect_trace,
        )


def make_ilqr_solver(plant: Plant, cost: CostModel, cfg: SolverConfig) -> _Solver:
    """Build the solve function for a (plant, cost, config) triple.

    Returns solve(x0, u0, goal, weights=None, *, P0=None, p0=None, d0=None,
                  initial_rollout=False, ignore_first_defect=False,
                  iter_limit=None) -> SolveOutput."""
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
