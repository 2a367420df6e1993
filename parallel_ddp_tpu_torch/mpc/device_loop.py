"""Closed-loop MPC with controller and plant on one device (twin of
`parallel_ddp_tpu/mpc/device_loop.py`).

The reference's lockstep MPC test runs solver and simulated plant in-process,
alternating solve and integrate (testMPC_lockstep, WAFR_MPC_examples.cu:
105-238).  The JAX package fuses the whole loop into one `lax.scan`; here it
is a Python loop over control steps whose every tensor stays on the device:
warm-start shift, budgeted re-solve, then the control period's plant substeps
under the kHz trajectory-runner control law as ONE call of the plant's
simulation chain (`ops/cuda_sim_chain.py`: on CUDA one kernel launch, with the
plant clock kept on the device), and the tracking-error metric.  Per-step
results are written into preallocated device tensors and read once, by the
caller, at the end; the tracking error is computed from them after the loop,
in one batched FK call.
The only host reads are the solver's own exit-flag reads (`host_syncs`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from parallel_ddp_tpu_torch.config import CostWeights
from parallel_ddp_tpu_torch.mpc.driver import MPCController, MPCState
from parallel_ddp_tpu_torch.ops.cuda_sim_chain import get_hardware_controls, make_sim_chain

__all__ = ["DeviceLoopResult", "get_hardware_controls", "make_device_mpc_loop"]


class DeviceLoopResult(NamedTuple):
    x: torch.Tensor          # (T, n_state) plant state at each control step end
    ee_err: torch.Tensor     # (T,) EE xyz tracking error (if plant has ee_pos)
    J: torch.Tensor          # (T,) solve cost
    accepted: torch.Tensor   # (T,) bool
    ok: torch.Tensor         # (T,) accepted or converged/feasible
    state: MPCState          # final solver state
    host_syncs: int = 0      # exit-flag reads on the host, summed over the solves


def make_device_mpc_loop(
    ctrl: MPCController,
    sim_rate_hz: float = 1000.0,
    control_period_s: float = 0.01,
    sim_integrator: int = 1,
    use_feedback: bool = True,
):
    """Build run(state, x0, t0, goals, weights) -> DeviceLoopResult.

    goals: a goal dict (the cost family's, e.g. "ee_goal" and "x_target")
    whose tensors have a leading (T,) axis; entry i is active during control
    step i (the figure-8 goal handler pattern,
    LCM_fig8_examples.cu:140-190).  T control steps of `control_period_s`,
    each containing round(control_period * sim_rate) plant substeps.  Every
    tensor lives on the device of `state`."""
    plant = ctrl.plant
    sim_dt = 1.0 / sim_rate_hz
    substeps = max(1, int(round(control_period_s * sim_rate_hz)))
    chain = make_sim_chain(plant, sim_integrator, sim_dt)
    has_ee = plant.ee_pos is not None
    n_pos, dt = plant.n_pos, ctrl.cfg.dt

    def run(st: MPCState, x0, t0, goals, weights: Optional[CostWeights] = None):
        w = weights if weights is not None else CostWeights()
        dev = st.x.device
        f32 = dict(dtype=torch.float32, device=dev)
        x = torch.as_tensor(x0, **f32)
        t = torch.as_tensor(t0, **f32)
        T = goals["x_target"].shape[0]
        xs = torch.empty((T, plant.n_state), **f32)
        js = torch.empty(T, **f32)
        accs = torch.empty(T, dtype=torch.bool, device=dev)
        oks = torch.empty(T, dtype=torch.bool, device=dev)
        syncs = 0
        for i in range(T):
            goal = {k: v[i] for k, v in goals.items()}
            st, info = ctrl._mpc_step(st, x, t, goal, w, ctrl.mpc.max_iters_per_solve)
            syncs += ctrl.host_syncs
            x_sub, t = chain.runner(st.x, st.u, st.K, st.t0, dt, t, x, substeps, use_feedback)
            x = x_sub[-1]
            xs[i] = x
            js[i] = info.J
            accs[i] = info.accepted
            oks[i] = info.ok
        # the error at the end of each control step, against that step's goal
        if has_ee:
            errs = torch.linalg.vector_norm(
                plant.ee_pos(xs[:, :n_pos])[:, :3] - goals["ee_goal"][:, :3], dim=-1)
        else:
            errs = torch.linalg.vector_norm(xs - goals["x_target"], dim=-1)
        return DeviceLoopResult(xs, errs, js, accs, oks, st, syncs)

    return run
