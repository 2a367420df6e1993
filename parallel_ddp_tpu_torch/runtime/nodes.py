"""Runtime nodes: the four concurrent loops of the online control stack
(twin of `parallel_ddp_tpu/runtime/nodes.py`; LCMHelpers.cuh; call-stack 3.3
in SURVEY.md).

  MPCLoopNode      <- LCM_MPCLoop_Handler (:173-267): on each STATUS, run one
                      budgeted warm-started MPC step (`MPCController.step`: on
                      the card one CUDA-graph replay), read the plan back in
                      one copy, publish TRAJ; consume GOAL / COST_PARAMS /
                      SOLVER_PARAMS updates.
  TrajRunnerNode   <- LCM_TrajRunner (:97-152): kHz loop; on each STATUS compute
                      u = u - K dx from the latest TRAJ (native evaluator) and
                      publish COMMAND.
  SimulatorNode    <- LCM_Simulator_Handler (:418-524): integrate the plant at a
                      fixed rate with substeps (`PlantSimulator`, on the card
                      by default: for the Kuka one chain-kernel launch a tick,
                      on a CUDA stream of its own), publish STATUS, consume
                      COMMAND.
  StatusFilterNode <- LCM_IIWA_STATUS_filter (:41-94): finite-difference velocity
                      estimates, republished on STATUS_FILTERED.
  snoop            <- the channel printer utilities (:286-416).

All nodes are `run(stop_event)` loops intended for threads or processes; any
subset can run on different machines (multicast bus), next to nodes of the
JAX package.

On the card `MPCLoopNode` makes no CUDA-graph capture after `warmup`: a
goal becomes device tensors once per GOAL message with an unchanged
structure, the live cost shift is a 0-d int32 device tensor that is always
in a dict goal, and the weights and the iteration cap are data of the
graph.  So new goals, cost sets, shifts and iteration or time limits are
replays of the same graphs (`captures()` counts them).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from parallel_ddp_tpu_torch.config import CostWeights
from parallel_ddp_tpu_torch.device import default_device
from parallel_ddp_tpu_torch.models.base import Plant
from parallel_ddp_tpu_torch.mpc.driver import MPCController, MPCState
from parallel_ddp_tpu_torch.mpc.simulator import PlantSimulator
from parallel_ddp_tpu_torch.runtime import messages as msg
from parallel_ddp_tpu_torch.runtime.pubsub import Channels, NativeTrajRunner, PubSub


def ee_goal_to_pytree(goal: msg.Goal, n_state: int = 14):
    """Standard Goal-message -> EE-cost goal-pytree mapping (the handleGoalEE /
    handleGoalqqd pair, LCMHelpers.cuh:195-201), as numpy arrays.  Mode 2 (EE
    twist) carries the velocity separately as ee_vel_goal instead of
    overwriting the rpy slots (see messages.Goal docstring for the
    reference's quirk)."""
    zeros6 = np.zeros(6, np.float32)
    xt = (np.asarray(goal.x_target, np.float32) if goal.x_target is not None
          else np.zeros(n_state, np.float32))
    if goal.mode == msg.Goal.MODE_JOINT:
        return {"ee_goal": zeros6, "x_target": np.asarray(goal.value, np.float32)}
    if goal.mode == msg.Goal.MODE_EE_TWIST:
        v = np.asarray(goal.value, np.float32)
        return {
            "ee_goal": np.concatenate([v[:3], np.zeros(3, np.float32)]),
            "ee_vel_goal": np.concatenate([v[3:6], np.zeros(3, np.float32)]),
            "x_target": xt,
        }
    return {"ee_goal": np.asarray(goal.value, np.float32), "x_target": xt}


def normalize_goal_pytree(goal_pt, cost_shift: int = 0):
    """Give a dict goal the EXACT structure MPCLoopNode solves with.

    The node always adds a 'cost_shift' leaf to dict goals (so a mid-loop
    useCostShift toggle is a value change, not a new CUDA-graph capture).  A
    graph captured for a goal WITHOUT that leaf (ctrl.warmup before starting
    the node) has another signature and is not the one the live solves
    replay.  Warmup callers must pass their goal through here.  A tensor goal
    gets a tensor leaf on its device, anything else a numpy int32."""
    if isinstance(goal_pt, dict) and "cost_shift" not in goal_pt:
        goal_pt = dict(goal_pt)
        like = next((v for v in goal_pt.values() if isinstance(v, torch.Tensor)), None)
        goal_pt["cost_shift"] = (np.int32(cost_shift) if like is None else
                                 torch.full((), cost_shift, dtype=torch.int32,
                                            device=like.device))
    return goal_pt


class MPCLoopNode:
    """The solver node.  `device`: where the controller's state lives
    (default: the card)."""

    def __init__(self, controller: MPCController, bus: PubSub,
                 goal_to_pytree: Callable[[msg.Goal], object],
                 initial_goal: msg.Goal,
                 weights: Optional[CostWeights] = None,
                 default_cost_shift: int = 0,
                 device=None):
        self.ctrl = controller
        self.bus = bus
        self.goal_to_pytree = goal_to_pytree
        self.goal = initial_goal
        self.weights = weights or CostWeights()
        self.device = torch.device(device) if device is not None else default_device()
        self.state: Optional[MPCState] = None
        self.solve_count = 0
        self.fail_count = 0
        # device-to-host reads after the solves: one a solve (iterations, ok
        # flag and the plan in a single copy)
        self.host_reads = 0
        # per-solve (wall-clock stamp, solve ms, iters) — the reference's
        # algTrace equivalent for the online stack (MPCHelpers.cuh:51-56)
        self.solve_trace: list = []
        # live solver params (lcmt_solver_params, applied per-solve without a
        # new capture: iterLimit/timeLimit as the graph's iteration cap,
        # useCostShift through the goal's cost_shift leaf —
        # LCMHelpers.cuh:204-214,213).  None until a message arrives: the
        # controller's own MPCConfig budget governs by default
        self.solver_params: Optional[msg.SolverParams] = None
        # the shift used until a SolverParams message arrives; MUST match a
        # nonzero final_cost_shift configured statically in the cost model,
        # else the injected leaf (which takes priority in costs/ee.py)
        # silently disables it
        self.default_cost_shift = default_cost_shift
        self._goal_of = None          # the Goal message the device goal was made from
        self._goal_dev = None
        self._shifts: dict = {}       # shift value -> 0-d int32 device tensor
        for ch in (Channels.STATUS, Channels.GOAL, Channels.COST_PARAMS,
                   Channels.SOLVER_PARAMS):
            bus.subscribe(ch)

    def _consume_config(self):
        m = self.bus.poll_new(Channels.GOAL)
        if m:
            self.goal = msg.Goal.unpack(m[0])
        m = self.bus.poll_new(Channels.COST_PARAMS)
        if m:
            self.weights = msg.CostParams.unpack(m[0]).weights
        m = self.bus.poll_new(Channels.SOLVER_PARAMS)
        if m:
            sp = msg.SolverParams.unpack(m[0])
            self.solver_params = sp
            if sp.clear_vars and self.state is not None:
                self.state = None  # force re-init on next status

    def _device_goal(self):
        """The goal pytree as device tensors, made once per Goal message."""
        if self._goal_of is not self.goal:
            self._goal_dev = pytree.tree_map(lambda a: torch.as_tensor(a, device=self.device),
                                             self.goal_to_pytree(self.goal))
            self._goal_of = self.goal
        return self._goal_dev

    def _shift_leaf(self, shift: int) -> torch.Tensor:
        leaf = self._shifts.get(shift)
        if leaf is None:
            leaf = self._shifts[shift] = torch.full((), shift, dtype=torch.int32,
                                                    device=self.device)
        return leaf

    def _goal_pytree(self):
        """User goal pytree (device tensors) + the live cost-shift (dict goals
        only).

        The cost_shift leaf is ALWAYS present for dict goals (defaulting to 0
        = the cost model's no-shift behavior): adding/removing a leaf changes
        the graph's signature, and a mid-loop useCostShift toggle must stay a
        value change, not a new capture stalling the real-time loop."""
        goal_pt = self._device_goal()
        shift = (self.solver_params.cost_shift if self.solver_params
                 else self.default_cost_shift)
        if isinstance(goal_pt, dict):
            goal_pt = dict(goal_pt)
            goal_pt["cost_shift"] = self._shift_leaf(int(shift))
        return goal_pt

    def captures(self) -> int:
        """CUDA graphs captured so far by the controller: its MPC step's and
        its cold-start solvers' (0 on the CPU)."""
        return len(self.ctrl.graphs) + sum(len(s.graphs)
                                           for s in self.ctrl._init_solvers.values())

    def warmup(self, x0, t0: float = 0.0):
        """Capture the node's EXACT programs before going live: the cold
        start's solve and the MPC step, with the goal structure the live
        solves use (cost_shift leaf included, default shift applied).  Call
        this instead of ctrl.warmup when the controller runs in a node."""
        goal_pt = self._goal_pytree()
        st = self.ctrl.init_state(np.asarray(x0, np.float32), t0=t0,
                                  goal=goal_pt, weights=self.weights, device=self.device)
        self.ctrl.warmup(st, goal_pt, self.weights)
        return st

    def _init(self, status: msg.Status, goal_pt) -> MPCState:
        return self.ctrl.init_state(status.x, t0=status.utime, goal=goal_pt,
                                    weights=self.weights, device=self.device)

    def solve(self, status: msg.Status) -> msg.Trajectory:
        """One solve for a STATUS: a re-init after a clearVars (or at the
        first status), the MPC step, then ONE read of (iterations, ok, t0,
        x, u, K) to the host; returns the trajectory to publish."""
        goal_pt = self._goal_pytree()
        if self.state is None:
            self.state = self._init(status, goal_pt)
            # run the step once NOW, then resync to the freshest status so the
            # loop starts hot (first-use work is paid before the live solves)
            self.ctrl.warmup(self.state, goal_pt, self.weights)
            m2 = self.bus.poll_new(Channels.STATUS)
            if m2:
                status = msg.Status.unpack(m2[0])
            self.state = self._init(status, goal_pt)
        sp = self.solver_params
        t_solve0 = time.perf_counter()
        self.state, info = self.ctrl.step(
            self.state, status.x, status.utime, goal_pt, self.weights,
            iter_limit=sp.iter_limit if sp else None,
            time_limit_ms=sp.time_limit_ms if sp else None,
        )
        # the one read: it waits for the solve, so the wall time covers its
        # completion (the budget model's calibration), not the enqueue
        iters, ok, t0, x, u, k_mat = msg.to_host(info.iters, info.ok, self.state.t0,
                                                 self.state.x, self.state.u, self.state.K)
        self.host_reads += 1
        solve_ms = (time.perf_counter() - t_solve0) * 1e3
        iters_done = int(iters)
        self.ctrl.calibrate_timing(solve_ms, iters_done)
        self.solve_trace.append((time.perf_counter(), solve_ms, iters_done))
        self.solve_count += 1
        if not bool(ok):
            self.fail_count += 1
        return msg.Trajectory(t0=float(t0), dt=self.ctrl.cfg.dt, x=x, u=u, K=k_mat)

    def run(self, stop: threading.Event, poll_s: float = 0.0005):
        while not stop.is_set():
            self._consume_config()
            m = self.bus.poll_new(Channels.STATUS)
            if not m:
                time.sleep(poll_s)
                continue
            traj = self.solve(msg.Status.unpack(m[0]))
            self.bus.publish(Channels.TRAJ, msg.pack_msg(traj, self.bus.wire))


class TrajRunnerNode:
    def __init__(self, n_state: int, n_ctrl: int, bus: PubSub,
                 use_feedback: bool = True,
                 traj_dt: Optional[float] = None,
                 traj_n: Optional[int] = None):
        """traj_dt (and traj_n for reference byte-size-quirk peers) configure
        decoding of LCM-format trajectories, whose wire carries neither — the
        reference's equivalents are compile-time constants
        (TRAJ_RUNNER_TIME_STEPS, LCMHelpers.cuh:100-123).  Native-format
        trajectories carry dt and need neither."""
        self.bus = bus
        self.n_state = n_state
        self.n_ctrl = n_ctrl
        self.traj_dt = traj_dt
        self.traj_n = traj_n
        self.native = NativeTrajRunner(n_state, n_ctrl)
        self.use_feedback = use_feedback
        self.command_count = 0
        self.overrun_count = 0
        # wall-clock stamp per published command: runner Hz + inter-command
        # jitter come from the diffs (the kHz-loop health metric the reference
        # reads off lcm-spy, LCMHelpers.cuh:286-416)
        self.command_stamps: list = []
        bus.subscribe(Channels.STATUS)
        bus.subscribe(Channels.TRAJ)

    def run(self, stop: threading.Event, poll_s: float = 0.0002):
        while not stop.is_set():
            m = self.bus.poll_new(Channels.TRAJ)
            if m:
                t = msg.Trajectory.unpack(m[0], nx=self.n_state,
                                          nu=self.n_ctrl, dt=self.traj_dt,
                                          n=self.traj_n)
                self.native.set_traj(t.x, t.u, t.K, t.t0, t.dt)
            m = self.bus.poll_new(Channels.STATUS)
            if not m:
                time.sleep(poll_s)
                continue
            status = msg.Status.unpack(m[0])
            u, rc = self.native.get_control(status.utime, status.x,
                                            self.use_feedback)
            if rc == 0:
                self.bus.publish(
                    Channels.COMMAND,
                    msg.pack_msg(msg.Command(status.utime, u, status.q),
                                 self.bus.wire),
                )
                self.command_count += 1
                self.command_stamps.append(time.perf_counter())
            elif rc == 1:
                self.overrun_count += 1  # fail loudly: past trajectory end


class SimulatorNode:
    """Plant-in-the-loop simulator publishing STATUS at a fixed rate; the
    plant runs on `device` (default: the card), on a CUDA stream of its own
    there, so a tick never waits for the solver's graph."""

    def __init__(self, plant: Plant, bus: PubSub, x0: np.ndarray,
                 rate_hz: float = 1000.0, substeps: int = 1,
                 integrator: int = 3, realtime: bool = True,
                 hold_until_command: bool = True, device=None):
        self.sim = PlantSimulator(plant, rate_hz=rate_hz, substeps=substeps,
                                  integrator=integrator, device=device)
        self._stream = (torch.cuda.Stream(device=self.sim.device)
                        if self.sim.device.type == "cuda" else None)
        self.bus = bus
        self.x = np.asarray(x0, np.float32)
        self.t = 0.0
        self.n_pos = plant.n_pos
        self.realtime = realtime
        self.u = np.zeros(plant.n_ctrl, np.float32)
        self.step_count = 0
        # brake the plant until the first command arrives, so a controller
        # that is still warming up doesn't meet a plant that already fell
        # (the reference's arm is gravity-compensated, MPC_MODE, so it holds
        # still for free; a gravity-loaded plant needs the explicit hold)
        self.hold_until_command = hold_until_command
        self.commanded = False
        bus.subscribe(Channels.COMMAND)

    def publish_status(self):
        self.bus.publish(
            Channels.STATUS,
            msg.pack_msg(
                msg.Status(self.t, self.x[: self.n_pos], self.x[self.n_pos:]),
                self.bus.wire,
            ),
        )

    def _step(self):
        if self._stream is None:
            return self.sim.step(self.x, self.u)
        with torch.cuda.stream(self._stream):
            return self.sim.step(self.x, self.u)

    def tick(self):
        m = self.bus.poll_new(Channels.COMMAND)
        if m:
            # either command flavor can drive the plant: Command (solver
            # stacks) or CommandHardware (hardware-shaped stacks, e.g.
            # TrajPlaybackNode's default) — both carry joint torques
            cmd = msg.unpack_any(m[0])
            self.u = cmd.tau
            self.commanded = True
        if self.commanded or not self.hold_until_command:
            self.x = self._step()
            self.step_count += 1
        self.t += self.sim.dt
        self.publish_status()

    def run(self, stop: threading.Event):
        next_t = time.perf_counter()
        self.publish_status()
        while not stop.is_set():
            self.tick()
            if self.realtime:
                next_t += self.sim.dt
                delay = next_t - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)


class StatusFilterNode:
    """Finite-difference velocity estimator (LCM_IIWA_STATUS_filter,
    LCMHelpers.cuh:41-94 — pass-through there; implemented for real here)."""

    def __init__(self, bus: PubSub, alpha: float = 0.0):
        self.bus = bus
        self.alpha = alpha
        self.prev: Optional[msg.Status] = None
        self.qd_est: Optional[np.ndarray] = None
        bus.subscribe(Channels.STATUS)

    def filter(self, s: msg.Status) -> msg.Status:
        """The status to republish for s (updates the estimate)."""
        if self.prev is not None and s.utime > self.prev.utime:
            qd = (s.q - self.prev.q) / (s.utime - self.prev.utime)
            if self.qd_est is None or self.alpha <= 0:
                self.qd_est = qd
            else:
                self.qd_est = self.alpha * self.qd_est + (1 - self.alpha) * qd
            out = msg.Status(s.utime, s.q, self.qd_est.astype(np.float32))
        else:
            out = s
        self.prev = s
        return out

    def run(self, stop: threading.Event, poll_s: float = 0.0002):
        while not stop.is_set():
            m = self.bus.poll_new(Channels.STATUS)
            if not m:
                time.sleep(poll_s)
                continue
            out = self.filter(msg.Status.unpack(m[0]))
            self.bus.publish(Channels.STATUS_FILTERED,
                             msg.pack_msg(out, self.bus.wire))


class TrajPlaybackNode:
    """Canned-trajectory playback at a fixed rate — the PID trajectory-tracker
    comms check (test/PIDTrajTracker.cu:44-90): wait for the first STATUS to
    latch the plant clock, then publish one command per tick paced by wall
    clock, carrying the canned position reference (and, in torque mode, the
    canned feedforward torques).  `hardware_mode` publishes the
    CommandHardware wrench variant (lcmt_iiwa_command_hardware), exercising
    the hardware-shaped message flow end-to-end without a solver."""

    def __init__(self, bus: PubSub, q_traj: np.ndarray, u_traj: np.ndarray,
                 rate_hz: float = 1000.0, torque_mode: bool = False,
                 hardware_mode: bool = True):
        self.bus = bus
        self.q_traj = np.asarray(q_traj, np.float32)
        self.u_traj = np.asarray(u_traj, np.float32)
        self.rate_hz = float(rate_hz)
        self.torque_mode = torque_mode
        self.hardware_mode = hardware_mode
        self.published = 0
        self.done = False
        bus.subscribe(Channels.STATUS)

    def _command(self, utime: float, k: int) -> bytes:
        tau = (self.u_traj[k] if self.torque_mode
               else np.zeros_like(self.u_traj[k]))
        if self.hardware_mode:
            return msg.pack_msg(
                msg.CommandHardware(utime, self.q_traj[k], tau,
                                    np.zeros(6, np.float32)),
                self.bus.wire,
            )
        return msg.pack_msg(msg.Command(utime, tau, self.q_traj[k]),
                            self.bus.wire)

    def run(self, stop: threading.Event, poll_s: float = 0.0002):
        # latch t0 from the first status (handleMessage, PIDTrajTracker.cu:51-53)
        t0 = None
        while not stop.is_set():
            m = self.bus.poll_new(Channels.STATUS)
            if m:
                t0 = msg.Status.unpack(m[0]).utime
                break
            time.sleep(poll_s)
        if t0 is None:
            return
        period = 1.0 / self.rate_hz
        next_t = time.perf_counter()
        for k in range(self.q_traj.shape[0]):
            if stop.is_set():
                return
            self.bus.publish(Channels.COMMAND, self._command(t0 + k * period, k))
            self.published += 1
            next_t += period
            delay = next_t - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
        self.done = True


def snoop(bus: PubSub, channel: str, duration: float = 1.0):
    """Channel sniffer (the debug printer utilities, LCMHelpers.cuh:286-416)."""
    bus.subscribe(channel)
    t_end = time.time() + duration
    seen = []
    while time.time() < t_end:
        m = bus.poll_new(channel)
        if m:
            seen.append(msg.unpack_any(m[0]))
        time.sleep(0.0005)
    return seen
