"""Warm-started receding-horizon MPC driver (twin of
`parallel_ddp_tpu/mpc/driver.py`; MPCHelpers.cuh).

The solver state (x, u, K, P, p, d) persists across solves on the device of
the measured state — the reference's GPUVars warm start; a measured state
given as a list or numpy array goes to the card (`device.default_device()`)
unless `init_state` is told another device.  Each control step:

  1. shift: roll every trajectory array left by the elapsed plant time
     (zero-order-hold the tail) — shiftAndCopy (MPCHelpers.cuh:425-471);
  2. re-rollout: overwrite the first shooting interval (or the full horizon)
     by open-loop simulation from the *measured* state xActual —
     rolloutMPC (MPCHelpers.cuh:523-563, FULL_ROLLOUT switch); one call of
     the plant's simulation chain (`ops/cuda_sim_chain.py`);
  3. solve: a fixed-iteration-budget iLQR solve warm-started from the shifted
     state (the budget is an iteration cap, `_resolve_iter_limit`);
  4. accept: on a failed solve (no iteration accepted) keep executing the
     shifted stale plan; after `solves_to_reset` consecutive failures zero
     P/p (and, optionally, u/K) for a cold restart (MPCHelpers.cuh:752-774,
     610, 668).

The shift index, accept and reset decisions stay on the device
(`torch.where` and index tensors).  On the CPU a step reads nothing on the
host beyond the solver's own exit-flag reads (`host_syncs`).  On the card
`step` replays one CUDA graph that holds the whole step (`graphs.py`;
captured once per static signature: the state's and goal's shapes), the
solve's loops as WHILE nodes: it reads nothing on the host, and goal, cost
weights (a device tensor of the graph), iteration cap and state may change
every call without a new capture (the reference jits its step the same
way).  `init_state` runs its cold solve through the solver's own graph.

A fleet of independent controllers advances in one program:
`init_state_batch` cold-starts B scenarios with one batched solve and
`step_batch` steps them all, one graph replay on the card (the reference's
`jax.vmap` of its step).  The state, measurement, clock and goal carry the
scenario axis; the weights and the iteration cap are shared.  A single step
is the same body at B = 1.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from parallel_ddp_tpu_torch import graphs
from parallel_ddp_tpu_torch.config import CostWeights, SolverConfig, weights_tensor
from parallel_ddp_tpu_torch.costs.base import CostModel
from parallel_ddp_tpu_torch.device import as_tensor
from parallel_ddp_tpu_torch.models.base import Plant
from parallel_ddp_tpu_torch.ops.cuda_sim_chain import make_sim_chain
from parallel_ddp_tpu_torch.ops.integrators import make_step
from parallel_ddp_tpu_torch.parallel.backward import per_scenario_mask
from parallel_ddp_tpu_torch.solver import make_ilqr_solver, refuse_tf32


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    """MPC options (config.cuh MPC group + MPCHelpers constants); the meaning
    of each field is documented on `parallel_ddp_tpu.mpc.driver.MPCConfig`."""

    max_iters_per_solve: int = 6      # the 10 ms budget analog
    # FULL_ROLLOUT: re-simulate the whole horizon (vs the first block only)
    # each warm start; restores zero defects every solve (MPCHelpers.cuh:37-38)
    full_rollout: bool = True
    solves_to_reset: int = 10         # SOLVES_TO_RESET (MPCHelpers.cuh:610)
    max_shift_steps: Optional[int] = None  # clamp on warm-start shift
    # online solves enforce the defect bound (LCMHelpers.cuh:242)
    ignore_defect_online: bool = False
    # the reference's reset also zeroes u/K (MPCHelpers.cuh:610,668); the
    # default restarts only the solver (P/p) and keeps the last feasible plan
    zero_controls_on_reset: bool = False


class MPCState(NamedTuple):
    """One controller's state; a fleet's fields carry a leading B."""
    x: torch.Tensor
    u: torch.Tensor
    K: torch.Tensor
    P: torch.Tensor
    p: torch.Tensor
    d: torch.Tensor
    t0: torch.Tensor      # plant time of x[0] (seconds), 0-d float32 ((B,) in a fleet)
    fails: torch.Tensor   # consecutive failed solves, 0-d int32 ((B,) in a fleet)


class MPCStepInfo(NamedTuple):
    J: torch.Tensor
    iters: torch.Tensor   # 0-d int32 on the state's device
    accepted: torch.Tensor
    shift_steps: torch.Tensor
    max_defect: torch.Tensor
    ok: torch.Tensor = None  # accepted OR converged (not a real failure)


def device_scalar(v, device, dtype=torch.float32) -> torch.Tensor:
    """v as a 0-d tensor on device: a tensor is moved, a number is written
    by a fill on the device (a copy from the host would synchronise)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype)
    return torch.full((), v, dtype=dtype, device=device)


def _shift(a: torch.Tensor, s) -> torch.Tensor:
    """a[k] <- a[min(k+s, N-1)] (ZOH tail fill, shiftAndCopy semantics);
    s is an int or a 0-d integer tensor on a's device that shifts a (N, ...),
    or one shift a scenario (B,) that shifts each a[b] (B, N, ...) by s[b]
    (a gather)."""
    if not (isinstance(s, torch.Tensor) and s.dim()):
        n = a.shape[0]
        return a.index_select(0, torch.clamp(torch.arange(n, device=a.device) + s, max=n - 1))
    n = a.shape[1]
    idx = torch.clamp(torch.arange(n, device=a.device) + s[:, None], max=n - 1)
    return torch.take_along_dim(a, idx.reshape(idx.shape + (1,) * (a.dim() - 2)), dim=1)



class MPCController:
    """The MPC step for a (plant, cost, solver config) triple."""

    def __init__(
        self,
        plant: Plant,
        cost: CostModel,
        cfg: SolverConfig,
        mpc_cfg: MPCConfig = MPCConfig(),
    ):
        self.plant = plant
        self.cost = cost
        self.cfg = cfg
        self.mpc = mpc_cfg
        solver_cfg = dataclasses.replace(cfg, max_iter=mpc_cfg.max_iters_per_solve)
        self._solver = make_ilqr_solver(plant, cost, solver_cfg)
        self._chain = make_sim_chain(plant, cfg.integrator, cfg.dt)
        self._step = make_step(plant, cfg.integrator, cfg.dt)   # single steps
        self._init_solvers: dict = {}  # warmup_iters -> solver
        self.graphs = graphs.GraphCache("mpc_step")
        self._host_syncs = 0
        # wall-clock budget model (see the reference's MPCController): a
        # time budget becomes an iteration cap time/per_iter, calibrated from
        # live solves as wall = overhead + per_iter*iters over the minimum
        # observed wall per iteration count
        self.per_iter_ms: Optional[float] = None
        self.overhead_ms: float = 0.0
        self._timing_min_ms: dict = {}

    @property
    def host_syncs(self) -> int:
        """Exit-flag reads on the host by the last step's solve (0 on the
        card, where the step is a graph replay)."""
        return self._host_syncs

    def _warmup_solver(self, warmup_iters: int):
        """Cached full-convergence solver for cold starts."""
        solver = self._init_solvers.get(warmup_iters)
        if solver is None:
            warm_cfg = dataclasses.replace(self.cfg, max_iter=warmup_iters)
            solver = make_ilqr_solver(self.plant, self.cost, warm_cfg)
            self._init_solvers[warmup_iters] = solver
        return solver

    def init_state(self, x_actual, t0: float = 0.0, goal=None,
                   weights: Optional[CostWeights] = None,
                   warmup_iters: int = 50, device=None) -> MPCState:
        """Cold-start: full-convergence solve from the measured state (the
        reference's warm-start solve with infinite budget,
        LCM_fig8_examples.cu:261-262).  A tensor x_actual keeps its device;
        anything else goes to `device` (default: the card)."""
        x = as_tensor(x_actual, dtype=torch.float32, device=device)
        n_steps = self.cfg.num_time_steps
        x0 = x[None].expand(n_steps, -1).clone()
        u0 = x.new_zeros((n_steps, self.plant.n_ctrl))
        out = self._warmup_solver(warmup_iters)(x0, u0, goal, weights, initial_rollout=True)
        return MPCState(
            x=out.x, u=out.u, K=out.K, P=out.P, p=out.p, d=out.d,
            t0=torch.full((), t0, dtype=torch.float32, device=x.device),
            fails=torch.zeros((), dtype=torch.int32, device=x.device),
        )

    def init_state_batch(self, x_actuals, t0s, goals,
                         weights: Optional[CostWeights] = None,
                         warmup_iters: int = 50, device=None) -> MPCState:
        """Cold-start a fleet: one batched full-convergence solve over the
        scenario axis.  x_actuals (B, n_state), t0s (B,), goals a pytree
        with a leading B on every tensor leaf.  Returns an MPCState whose
        fields carry the scenario axis."""
        x = as_tensor(x_actuals, dtype=torch.float32, device=device)
        B, n_steps = x.shape[0], self.cfg.num_time_steps
        x0 = x[:, None].expand(B, n_steps, -1).clone()
        u0 = x.new_zeros((B, n_steps, self.plant.n_ctrl))
        out = self._warmup_solver(warmup_iters).solve_batch(x0, u0, goals, weights,
                                                            initial_rollout=True)
        return MPCState(
            x=out.x, u=out.u, K=out.K, P=out.P, p=out.p, d=out.d,
            t0=torch.as_tensor(t0s, dtype=torch.float32, device=x.device).reshape(B),
            fails=torch.zeros((B,), dtype=torch.int32, device=x.device),
        )

    def _warm_start(self, st: MPCState, x_actual, s):
        """Shift and re-rollout, for one controller (s an int or 0-d) or a
        fleet (every field of st, x_actual and s with a leading B)."""
        x = _shift(st.x, s)
        u = _shift(st.u, s)
        k_mat = _shift(st.K, s)
        p_mat = _shift(st.P, s)
        p_vec = _shift(st.p, s)

        # re-rollout from the measured state with the shifted open-loop
        # controls (rolloutMPC, MPCHelpers.cuh:523-563)
        n_steps, nf = self.cfg.num_time_steps, self.cfg.n_blocks_f
        n_roll = n_steps if self.mpc.full_rollout else nf
        x_sim = self._chain.open_loop(x_actual, u[..., :n_roll - 1, :])
        x_last = x_sim[..., -1, :] if n_roll > 1 else x_actual
        x = torch.cat([x_actual[..., None, :], x_sim, x[..., n_roll:, :]], dim=-2)

        if self.mpc.full_rollout or self.cfg.m_blocks_f == 1:
            # the whole horizon is one contiguous simulation: zero defects
            d = torch.zeros_like(st.d)
        else:
            # shifting moves the old defects off the (fixed) block boundaries
            d = _shift(st.d, s)
            # boundaries that landed in the ZOH tail (k + s >= N-1) repeat the
            # final state on both sides, so the shifted defect reads zero while
            # the true defect there is step(x[N-1], u[N-1]) - x[N-1]
            last = x[..., n_steps - 1, :]
            d_tail = self._step(last, u[..., n_steps - 1, :]) - last
            bidx = torch.arange(1, self.cfg.m_blocks_f, device=x.device) * nf - 1
            s_b = s[..., None] if isinstance(s, torch.Tensor) else s
            in_tail = bidx + s_b >= n_steps - 1
            d = d.index_copy(-2, bidx, torch.where(in_tail[..., None], d_tail[..., None, :],
                                                   d.index_select(-2, bidx)))
            # the first boundary's defect is exact (block 0 was just
            # re-simulated from the measured state); written LAST so it wins
            # over the tail approximation above
            b0 = nf - 1
            d[..., b0, :] = self._step(x_last, u[..., b0, :]) - x[..., b0 + 1, :]
        return x, u, k_mat, p_mat, p_vec, d

    def _mpc_step(self, st: MPCState, x_actual, t_now, goal, weights, iter_limit):
        """The step's body (what `step` and `step_batch` capture on the
        card), for one controller or a fleet (st.x (B, N, n): every input but
        the weights and the cap with a leading B).  iter_limit is an int in
        [1, max_iters_per_solve] or a 0-d integer tensor; weights a (21,)
        tensor or a `CostWeights`."""
        if st.x.dim() == 2:         # one controller: the fleet's body at B = 1
            new_state, info = self._fleet_step(
                MPCState(*(a[None] for a in st)), x_actual[None], t_now.reshape(1), goal,
                weights, iter_limit, shared_goal=True)
            return (MPCState(*(a[0] for a in new_state)),
                    MPCStepInfo(*(None if a is None else a[0] for a in info)))
        return self._fleet_step(st, x_actual, t_now, goal, weights, iter_limit)

    def shift_steps(self, t0, t_now) -> torch.Tensor:
        """The warm start's shift, int32 on the device: the knots the plant
        clock moved since t0, in [0, N-1], clamped by max_shift_steps."""
        s = torch.floor((t_now - t0) / self.cfg.dt).to(torch.int32)   # MPCHelpers.cuh:875
        s = torch.clamp(s, 0, self.cfg.num_time_steps - 1)
        if self.mpc.max_shift_steps is not None:
            s = torch.clamp(s, max=self.mpc.max_shift_steps)
        return s

    def _fleet_step(self, st: MPCState, x_actual, t_now, goal, weights, iter_limit,
                    shared_goal: bool = False):
        s = self.shift_steps(st.t0, t_now)
        t0_new = st.t0 + s.to(torch.float32) * self.cfg.dt

        x_w, u_w, k_w, pm_w, pv_w, d_w = self._warm_start(st, x_actual, s)

        out, self._host_syncs = self._solver.run_batch(
            x_w, u_w, goal, pm_w, pv_w, d_w, iter_limit, weights,
            initial_rollout=False, ignore_first_defect=self.mpc.ignore_defect_online,
            shared_goal=shared_goal)
        accepted = (out.alpha_trace[:, 1:] >= 0).any(-1)

        # failure handling (storeVarsGPU_MPC, MPCHelpers.cuh:752-774): a solve
        # that accepted nothing because there was nothing to improve
        # (converged) or whose candidates were feasible but rejected
        # (last_feasible) is a success; see the reference for why
        ok = accepted | out.converged | out.last_feasible

        def pick(new, old):
            return torch.where(per_scenario_mask(accepted, new), new, old)

        fails = torch.where(ok, torch.zeros_like(st.fails), st.fails + 1)
        reset = fails >= self.mpc.solves_to_reset
        fails = torch.where(reset, torch.zeros_like(fails), fails)

        def zero_on_reset(arr):
            return torch.where(per_scenario_mask(reset, arr), torch.zeros_like(arr), arr)

        def maybe_zero(arr):
            return zero_on_reset(arr) if self.mpc.zero_controls_on_reset else arr

        new_state = MPCState(
            x=pick(out.x, x_w),
            u=maybe_zero(pick(out.u, u_w)),
            K=maybe_zero(pick(out.K, k_w)),
            P=zero_on_reset(pick(out.P, pm_w)),
            p=zero_on_reset(pick(out.p, pv_w)),
            d=pick(out.d, d_w),
            t0=t0_new, fails=fails,
        )
        info = MPCStepInfo(
            J=out.J, iters=out.iters, accepted=accepted,
            shift_steps=s, max_defect=out.max_defect, ok=ok,
        )
        return new_state, info

    def _resolve_iter_limit(self, iter_limit: Optional[int],
                            time_limit_ms: Optional[float]) -> int:
        """Fold the live iterLimit/timeLimit solver params (lcmt_solver_params,
        LCMHelpers.cuh:213) into one iteration cap.  A wall-clock budget maps
        through the measured per-iteration latency (self.per_iter_ms)."""
        cap = self.mpc.max_iters_per_solve
        if iter_limit is not None:
            cap = min(cap, int(iter_limit))
        if time_limit_ms is not None and self.per_iter_ms:
            budget = time_limit_ms - self.overhead_ms
            cap = min(cap, max(1, int(budget / self.per_iter_ms)))
        return max(1, cap)

    def warmup(self, st: MPCState, goal, weights: Optional[CostWeights] = None):
        """Run one MPC step and discard it, so the first live step does not
        pay for first-use work (kernel build, per-device constants)."""
        out = self.step(st, st.x[0], st.t0, goal, weights)
        if out[0].x.device.type == "cuda":
            torch.cuda.synchronize(out[0].x.device)

    def calibrate_timing(self, solve_ms: float, iters: int):
        """Record a measured (solve wall time, iterations executed) pair to
        build the per-iteration latency model used by time_limit_ms budgets.

        Measure wall time around a synchronised solve.  With samples at two or
        more distinct iteration counts the fixed per-solve overhead is
        separated out by a two-point secant over the per-count minima; with
        one count, wall/iters is the (conservative) fallback."""
        if iters <= 0:
            return
        prev = self._timing_min_ms.get(iters)
        if prev is None or solve_ms < prev:
            self._timing_min_ms[iters] = solve_ms
        pts = sorted(self._timing_min_ms.items())
        if len(pts) >= 2:
            (i_lo, w_lo), (i_hi, w_hi) = pts[0], pts[-1]
            slope = (w_hi - w_lo) / (i_hi - i_lo)
            if slope > 0:
                self.per_iter_ms = slope
                self.overhead_ms = max(0.0, w_lo - slope * i_lo)
                return
        self.per_iter_ms = min(w / i for i, w in pts)
        self.overhead_ms = 0.0

    def step(self, st: MPCState, x_actual, t_now, goal,
             weights: Optional[CostWeights] = None,
             iter_limit: Optional[int] = None,
             time_limit_ms: Optional[float] = None):
        """One MPC re-solve: shift + warm start + budgeted solve.

        x_actual: measured state; t_now: plant clock (s); goal, weights,
        iter_limit and time_limit_ms may change every call (the reference's
        GOAL/COST_PARAMS/SOLVER_PARAMS channels, LCMHelpers.cuh:204-214)."""
        dev = st.x.device
        return self._replay_step(
            st, torch.as_tensor(x_actual, dtype=torch.float32, device=dev),
            device_scalar(t_now, dev), goal, weights, iter_limit, time_limit_ms)

    def step_batch(self, sts: MPCState, x_actuals, t_nows, goals,
                   weights: Optional[CostWeights] = None,
                   iter_limit: Optional[int] = None,
                   time_limit_ms: Optional[float] = None):
        """One warm-started budgeted MPC period for a fleet of scenarios:
        sts (an `init_state_batch` state), x_actuals (B, n_state), t_nows
        (B,) and goals (a leading B on every tensor leaf) carry the scenario
        axis; weights and the iteration cap are shared.  On the card one
        graph replay, keyed by shapes only."""
        dev = sts.x.device
        return self._replay_step(
            sts, torch.as_tensor(x_actuals, dtype=torch.float32, device=dev),
            torch.as_tensor(t_nows, dtype=torch.float32, device=dev), goals, weights,
            iter_limit, time_limit_ms)

    def _replay_step(self, st, x, t, goal, weights, iter_limit, time_limit_ms):
        dev = st.x.device
        args = (st, x, t, goal, weights_tensor(weights, dev),
                self._resolve_iter_limit(iter_limit, time_limit_ms))
        if not graphs.replayed(dev):
            return self._mpc_step(*args)
        refuse_tf32(dev)
        graph = self.graphs.get(graphs.signature(args), self._mpc_step, args)
        out = graph(*args)
        self._host_syncs = 0
        return out
