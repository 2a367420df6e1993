"""Plant simulator + lockstep closed-loop MPC harness (twin of
`parallel_ddp_tpu/mpc/simulator.py`, same API).

Two modes, mirroring the reference:
  * `PlantSimulator` — a stand-alone stepped simulator with substeps
    (kukaLCMSimulator / LCM_Simulator_Handler, LCMHelpers.cuh:418-524);
  * `run_lockstep_mpc` — deterministic in-process closed loop: advance the
    plant by a fixed control period per solve, exactly the reference's
    `testMPC_lockstep` (WAFR_MPC_examples.cu:105-238), with the trajectory
    runner on the host (numpy, `mpc/controls.py`) — the deployment topology.
    `mpc/device_loop.py` keeps the whole loop on the device instead.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from parallel_ddp_tpu_torch.config import CostWeights
from parallel_ddp_tpu_torch.device import default_device
from parallel_ddp_tpu_torch.models.base import Plant
from parallel_ddp_tpu_torch.mpc.controls import TrajHandoff, get_hardware_controls
from parallel_ddp_tpu_torch.mpc.driver import MPCController, MPCState
from parallel_ddp_tpu_torch.ops.cuda_sim_chain import make_sim_chain


class PlantSimulator:
    """Integrate the true plant at a control rate with substeps, on `device`
    (default: the card; numpy in, numpy out)."""

    def __init__(self, plant: Plant, rate_hz: float = 1000.0, substeps: int = 1,
                 integrator: int = 3, device=None):
        self.plant = plant
        self.dt = 1.0 / rate_hz
        self.substeps = substeps
        self.device = torch.device(device) if device is not None else default_device()
        self._chain = make_sim_chain(plant, integrator, self.dt / substeps)

    def step(self, x: np.ndarray, u: np.ndarray) -> np.ndarray:
        f32 = dict(dtype=torch.float32, device=self.device)
        xt, ut = torch.tensor(np.asarray(x), **f32), torch.tensor(np.asarray(u), **f32)
        # the substeps hold the control: one chain call
        xs = self._chain.open_loop(xt, ut.expand(self.substeps, -1))
        return xs[-1].cpu().numpy()


class LockstepResult(NamedTuple):
    t: np.ndarray          # (T,)
    x: np.ndarray          # (T, n_state) plant states
    u: np.ndarray          # (T, n_ctrl) applied controls
    J: np.ndarray          # (S,) solve costs
    accepted: np.ndarray   # (S,) solve successes
    solve_times: np.ndarray  # (S,) wall seconds per MPC step


def run_lockstep_mpc(
    controller: MPCController,
    sim: PlantSimulator,
    x_start: np.ndarray,
    duration: float,
    goal_fn: Callable[[float], object],
    control_period: float = 0.01,
    weights: Optional[CostWeights] = None,
    use_feedback: bool = True,
) -> LockstepResult:
    """Closed loop: every `control_period` run one MPC solve; between solves the
    trajectory runner applies u - K dx at the simulator rate.  The solver runs
    on the simulator's device; goal_fn(t) returns goals on that device."""
    x = np.asarray(x_start, np.float32)
    t = 0.0
    dev = sim.device
    st: MPCState = controller.init_state(torch.as_tensor(x, device=dev), t0=0.0,
                                         goal=goal_fn(0.0), weights=weights)

    ts, xs, us, js, accs, wall = [], [], [], [], [], []
    steps_per_solve = max(1, int(round(control_period / sim.dt)))
    n_solves = int(duration / control_period)

    for _ in range(n_solves):
        t0 = time.perf_counter()
        st, info = controller.step(st, x, t, goal_fn(t), weights)
        traj = TrajHandoff(
            x=st.x.cpu().numpy(), u=st.u.cpu().numpy(), K=st.K.cpu().numpy(),
            t0=float(st.t0), dt=controller.cfg.dt,
        )
        wall.append(time.perf_counter() - t0)
        js.append(float(info.J))
        accs.append(bool(info.accepted))

        for _ in range(steps_per_solve):
            u_out, ok = get_hardware_controls(traj, t, x, use_feedback=use_feedback)
            if not ok:
                u_out = np.zeros(controller.plant.n_ctrl, np.float32)
            ts.append(t)
            xs.append(x.copy())
            us.append(u_out.copy())
            x = sim.step(x, u_out)
            t += sim.dt

    return LockstepResult(
        t=np.asarray(ts), x=np.asarray(xs), u=np.asarray(us),
        J=np.asarray(js), accepted=np.asarray(accs), solve_times=np.asarray(wall),
    )
