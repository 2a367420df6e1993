"""Pick-and-place task family (twin of `parallel_ddp_tpu/tasks/pick_and_place.py`;
LCM_pickNPlace_examples.cu:40-135).

The reference's goal handler is a small state machine driven by arm status:

  * hold a target at (x, y, 0.1) with x ~ U(0.4, 0.6), y ~ U(0.35, 0.75),
    alternating sides of the table (updateGoal, :77-81);
  * when the arm settles — EE error norm < E_NORM_LIM and joint velocity norm
    < V_NORM_LIM (evNorm, exampleUtils.cuh:87-91) — pick the next waypoint and
    publish: the new goal (lcmt_target_twist), a solver-params message with
    clearVars=1 and a 10x time budget for the re-plan transient, and the
    default cost set (:103-121);
  * when close to the goal (eNorm < 2*E_NORM_LIM), switch to the stiffer
    "close" cost set Q_EE1 75 / QF_EE1 500 for precise settling (:123-126);
  * once moving toward the new goal (eNorm < 0.95 * eNormMax), restore the
    normal MPC solver limits with useCostShift=1 (:128-133).

Two implementations:
  * `PickAndPlaceGoalNode` — the runtime-plane node publishing over the bus
    (GOAL / SOLVER_PARAMS / COST_PARAMS channels), drop-in alongside
    MPCLoopNode / TrajRunnerNode / SimulatorNode (numpy, the same bytes as
    the JAX package's node);
  * `make_pick_place_device_loop` — the on-device variant: MPC step, the
    control period's plant substeps and the waypoint state machine as one
    control step on the device of the controller's state.  On the card a
    control step is ONE CUDA-graph replay that reads and writes at a step
    index kept on the device, with the waypoint index on the device too:
    0 host reads a step.  On the CPU a host loop runs the same body.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from parallel_ddp_tpu_torch import graphs
from parallel_ddp_tpu_torch.config import CostWeights, weights_tensor
from parallel_ddp_tpu_torch.device import as_tensor
from parallel_ddp_tpu_torch.mpc import device_loop
from parallel_ddp_tpu_torch.mpc.driver import MPCState, device_scalar
from parallel_ddp_tpu_torch.ops.cuda_sim_chain import make_sim_chain
from parallel_ddp_tpu_torch.runtime import messages as msg
from parallel_ddp_tpu_torch.runtime.pubsub import Channels
from parallel_ddp_tpu_torch.solver import refuse_tf32

# cost sets (LCM_pickNPlace_examples.cu:12-27); SMALL = 0 there
_PNP_BASE = dict(
    q_ee1=25.0, q_ee2=0.0, qf_ee1=250.0, qf_ee2=0.0,
    r_ee=0.001, q_xdee=10.0, qf_xdee=10.0, q_xee=0.0, qf_xee=0.0,
)


def default_weights() -> CostWeights:
    return CostWeights(**_PNP_BASE)


def close_weights() -> CostWeights:
    """Stiffer settle weights (_Q_EE1_CLOSE 75 / _QF_EE1_CLOSE 500)."""
    return CostWeights(**{**_PNP_BASE, "q_ee1": 75.0, "qf_ee1": 500.0})


@dataclasses.dataclass(frozen=True)
class PickAndPlaceConfig:
    e_norm_lim: float = 0.10        # E_NORM_LIM (:9)
    v_norm_lim: float = 0.10        # V_NORM_LIM (:10)
    iter_limit: int = 10
    time_limit_ms: float = 10.0
    x_range: Tuple[float, float] = (0.4, 0.6)    # randX (:19)
    y_range: Tuple[float, float] = (0.35, 0.75)  # randY, sign alternates (:20)
    z: float = 0.1                               # z always 0.1 (:73)
    replan_time_factor: float = 10.0             # time*10 on goal switch (:113)


def sample_waypoints(cfg: PickAndPlaceConfig, n: int,
                     rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """(n, 3) alternating-side waypoint sequence (updateGoal semantics)."""
    rng = rng or np.random.default_rng(0)
    xs = rng.uniform(*cfg.x_range, size=n)
    ys = rng.uniform(*cfg.y_range, size=n) * np.where(np.arange(n) % 2, -1.0, 1.0)
    return np.stack([xs, ys, np.full(n, cfg.z)], axis=-1).astype(np.float32)


class WaypointRecord(NamedTuple):
    goal: np.ndarray
    t_set: float        # plant time when the goal became active
    t_settled: Optional[float]  # plant time when e/v norms dropped below limits


class PickAndPlaceGoalNode:
    """Bus-plane goal sequencer (LCM_PickAndPlaceGoal_Handler analog).
    `ee_pos_fn(q)` maps joint positions (numpy) to the EE position; its first
    three entries are used."""

    def __init__(self, bus, ee_pos_fn: Callable[[np.ndarray], np.ndarray],
                 cfg: PickAndPlaceConfig = PickAndPlaceConfig(),
                 rng: Optional[np.random.Generator] = None,
                 n_pos: int = 7):
        self.bus = bus
        self.ee_pos_fn = ee_pos_fn
        self.cfg = cfg
        self.rng = rng or np.random.default_rng(0)
        self.n_pos = n_pos
        self.side = False
        self.goal = self._sample_goal()
        self.e_norm_max = 0.0
        self.close_sent = False
        self.vars_sent = True
        self.records: List[WaypointRecord] = [WaypointRecord(self.goal, 0.0, None)]
        bus.subscribe(Channels.STATUS)

    def _sample_goal(self) -> np.ndarray:
        x = self.rng.uniform(*self.cfg.x_range)
        y = self.rng.uniform(*self.cfg.y_range) * (-1.0 if self.side else 1.0)
        self.side = not self.side
        return np.asarray([x, y, self.cfg.z], np.float32)

    def _ev_norm(self, status) -> Tuple[float, float]:
        """EE position error and joint-velocity norms (evNorm,
        exampleUtils.cuh:87-91)."""
        ee = np.asarray(self.ee_pos_fn(status.q))[:3]
        e_norm = float(np.linalg.norm(ee - self.goal))
        v_norm = float(np.linalg.norm(status.qd))
        return e_norm, v_norm

    def _publish_goal(self, utime: float):
        twist = np.concatenate([self.goal, np.zeros(3, np.float32)])
        self.bus.publish(Channels.GOAL,
                         msg.Goal(msg.Goal.MODE_EE_TWIST, twist).pack())

    def _publish_solver_params(self, clear_vars: bool, cost_shift: int,
                               time_factor: float = 1.0):
        self.bus.publish(
            Channels.SOLVER_PARAMS,
            msg.SolverParams(
                iter_limit=self.cfg.iter_limit,
                time_limit_ms=self.cfg.time_limit_ms * time_factor,
                clear_vars=clear_vars,
                cost_shift=cost_shift,
            ).pack(),
        )

    def _publish_cost(self, w: CostWeights):
        self.bus.publish(Channels.COST_PARAMS, msg.CostParams(w).pack())

    def handle_status(self, status) -> None:
        """One state-machine step (handleStatus, LCM_pickNPlace_examples.cu:96-134)."""
        e_norm, v_norm = self._ev_norm(status)

        if e_norm < self.cfg.e_norm_lim and v_norm < self.cfg.v_norm_lim:
            # settled: record, advance to a new waypoint, trigger a re-plan
            self.records[-1] = self.records[-1]._replace(t_settled=status.utime)
            self.goal = self._sample_goal()
            self.records.append(WaypointRecord(self.goal, status.utime, None))
            e_norm, _ = self._ev_norm(status)
            self.e_norm_max = e_norm
            self.close_sent = False
            self.vars_sent = False
            self._publish_goal(status.utime)
            self._publish_solver_params(
                clear_vars=True, cost_shift=0,
                time_factor=self.cfg.replan_time_factor,
            )
            self._publish_cost(default_weights())
        elif not self.close_sent and e_norm < 2.0 * self.cfg.e_norm_lim:
            self.close_sent = True
            self._publish_cost(close_weights())
        elif not self.vars_sent and e_norm < 0.95 * self.e_norm_max:
            self.vars_sent = True
            self._publish_solver_params(clear_vars=False, cost_shift=1)

    def run(self, stop: threading.Event, poll_s: float = 0.0005):
        while not stop.is_set():
            m = self.bus.poll_new(Channels.STATUS)
            if not m:
                time.sleep(poll_s)
                continue
            self.handle_status(msg.Status.unpack(m[0]))

    def settle_times(self) -> List[float]:
        """Per-waypoint settle durations (plant seconds) for completed waypoints."""
        return [
            r.t_settled - r.t_set for r in self.records if r.t_settled is not None
        ]


class PickPlaceLoopResult(NamedTuple):
    x: torch.Tensor          # (T, n_state) plant state per control step
    e_norm: torch.Tensor     # (T,) EE error norm to the active goal
    v_norm: torch.Tensor     # (T,)
    wp_idx: torch.Tensor     # (T,) int32 active waypoint per step
    waypoints_done: torch.Tensor  # 0-d int32: waypoints settled
    J: torch.Tensor          # (T,) solve cost
    accepted: torch.Tensor   # (T,) bool
    ok: torch.Tensor         # (T,) accepted or converged/feasible
    state: MPCState          # final solver state
    host_syncs: int = 0      # host reads of device values over the run (0 on the card)


def make_pick_place_device_loop(
    ctrl,
    waypoints: np.ndarray,
    cfg: PickAndPlaceConfig = PickAndPlaceConfig(),
    sim_rate_hz: float = 1000.0,
    control_period_s: float = 0.01,
    sim_integrator: int = 1,
):
    """On-device pick-and-place: MPC + plant + waypoint state machine.
    `ctrl` is an MPCController over the Kuka EE cost; `waypoints` is (K, 3)
    from `sample_waypoints`.

    A control step: the active waypoint's goal, the EE error and joint speed,
    the cost set (`torch.where` between the close and default (21,) weight
    tensors: close when eNorm < 2*E_NORM_LIM — the device analog of the
    close-cost publish), one MPC step capped at min(iter_limit,
    max_iters_per_solve) iterations, the period's plant substeps through the
    plant's simulation chain in runner mode (the trajectory runner's control
    law each substep), then the settle test that advances the waypoint
    index.  Returns run(st, x0, t0, n_steps, replay=None) ->
    PickPlaceLoopResult, every tensor on the device of st; replay=False runs
    the host loop on any device (the card's eager check), None replays on
    the card.  `run.graphs` holds the control step's captures."""
    plant = ctrl.plant
    n_pos, n_state = plant.n_pos, plant.n_state
    wps = np.asarray(waypoints, np.float32)
    K = wps.shape[0]
    sim_dt = 1.0 / sim_rate_hz
    substeps = max(1, int(round(control_period_s * sim_rate_hz)))
    chain = make_sim_chain(plant, sim_integrator, sim_dt)
    it_cap = min(cfg.iter_limit, ctrl.mpc.max_iters_per_solve)
    dt = ctrl.cfg.dt
    cache = graphs.GraphCache("pick_place_step")
    consts_on: dict = {}

    def constants(dev):
        """(waypoints, default weights, close weights, zeros(3), zeros(n_state))
        on dev, copied there once (a later run makes no copy from the host)."""
        if dev not in consts_on:
            f32 = dict(dtype=torch.float32, device=dev)
            consts_on[dev] = (torch.as_tensor(wps, **f32), weights_tensor(default_weights(), dev),
                              weights_tensor(close_weights(), dev), torch.zeros(3, **f32),
                              torch.zeros(n_state, **f32))
        return consts_on[dev]

    def ev_norms(x, goal_xyz):
        ee = plant.ee_pos(x[:n_pos])[:3]
        return (torch.linalg.vector_norm(ee - goal_xyz), torch.linalg.vector_norm(x[n_pos:]))

    def control_step(st, x, t, wp_i, consts):
        """One control step: (state, plant state, clock, next waypoint index,
        the step's outputs)."""
        wps_d, w_def, w_close, zeros3, zeros_n = consts
        goal_xyz = wps_d.index_select(0, torch.clamp(wp_i, max=K - 1).reshape(1))[0]
        goal = {"ee_goal": torch.cat([goal_xyz, zeros3]), "x_target": zeros_n}
        e_norm, v_norm = ev_norms(x, goal_xyz)
        # close-cost swap (the device analog of the COST_PARAMS publish)
        w = torch.where(e_norm < 2.0 * cfg.e_norm_lim, w_close, w_def)
        st, info = ctrl._mpc_step(st, x, t, goal, w, it_cap)
        xs, t = chain.runner(st.x, st.u, st.K, st.t0, dt, t, x, substeps, True)
        x_new = xs[-1]
        # settle test advances the waypoint (the GOAL publish analog)
        e2, v2 = ev_norms(x_new, goal_xyz)
        settled = torch.logical_and(e2 < cfg.e_norm_lim, v2 < cfg.v_norm_lim)
        wp_next = torch.where(settled, torch.clamp(wp_i + 1, max=K), wp_i)
        return st, x_new, t, wp_next, (x_new, e_norm, v_norm, wp_i, info.J, info.accepted,
                                       info.ok)

    def graphed_step(st, x, t, wp_i, consts, i, res):
        """The captured step: carries state, plant state, clock and waypoint
        index in place, writes result i, advances i."""
        st_new, x_new, t_new, wp_new, outs = control_step(st, x, t, wp_i, consts)
        # the results first: one of them is the step's waypoint index, wp_i
        for buf, value in zip(res, outs):
            buf.index_copy_(0, i, value.reshape((1,) + buf.shape[1:]))
        for held, new in zip(st, st_new):
            held.copy_(new)
        x.copy_(x_new)
        t.copy_(t_new)
        wp_i.copy_(wp_new)
        i.add_(1)

    def run_graphed(st, x, t, wp, consts, out):
        T, rows = out[0].shape[0], device_loop.STEPS_PER_LOAD
        example = (st, x, t, wp, consts, torch.zeros(1, dtype=torch.int64, device=x.device),
                   tuple(o[:1].expand((rows,) + o.shape[1:]) for o in out))
        graph = cache.get(graphs.signature(example), graphed_step, example)
        s_st, s_x, s_t, s_wp, s_consts, s_i, s_res = graph.args
        # the capture's warm-up ran the body on the static buffers: load all
        for held, new in zip((*s_st, s_x, s_t, s_wp, *s_consts), (*st, x, t, wp, *consts)):
            held.copy_(new)
        for j in range(0, T, rows):
            m = min(rows, T - j)
            s_i.zero_()
            for _ in range(m):
                graph.replay()
            for o, buf in zip(out, s_res):
                o[j:j + m].copy_(buf[:m])
        return MPCState(*(a.clone() for a in s_st)), s_wp.clone()

    def run(st: MPCState, x0, t0, n_steps: int, replay: Optional[bool] = None
            ) -> PickPlaceLoopResult:
        dev = st.x.device
        consts = constants(dev)
        x = as_tensor(x0, dtype=torch.float32, device=dev)
        t = device_scalar(t0, dev)
        wp = torch.zeros((), dtype=torch.int32, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        flag = dict(dtype=torch.bool, device=dev)
        out = (torch.empty((n_steps, n_state), **f32), torch.empty(n_steps, **f32),
               torch.empty(n_steps, **f32), torch.empty(n_steps, dtype=torch.int32, device=dev),
               torch.empty(n_steps, **f32), torch.empty(n_steps, **flag),
               torch.empty(n_steps, **flag))
        syncs = 0
        if graphs.replayed(dev) if replay is None else replay:
            refuse_tf32(dev)
            st, wp = run_graphed(st, x, t, wp, consts, out)
        else:
            for k in range(n_steps):
                st, x, t, wp, outs = control_step(st, x, t, wp, consts)
                syncs += ctrl.host_syncs
                for o, value in zip(out, outs):
                    o[k] = value
        xs, es, vs, wis, js, accs, oks = out
        return PickPlaceLoopResult(xs, es, vs, wis, wp, js, accs, oks, st, syncs)

    run.graphs = cache
    return run
