"""Closed-loop MPC with controller and plant on one device (twin of
`parallel_ddp_tpu/mpc/device_loop.py`).

The reference's lockstep MPC test runs solver and simulated plant in-process,
alternating solve and integrate (testMPC_lockstep, WAFR_MPC_examples.cu:
105-238).  The JAX package fuses the whole loop into one `lax.scan`.  Here a
control step is the warm-start shift, the budgeted re-solve, then the control
period's plant substeps under the kHz trajectory-runner control law as ONE
call of the plant's simulation chain (`ops/cuda_sim_chain.py`: on CUDA one
kernel launch, with the plant clock kept on the device), every tensor on the
device of the state:
  * on the card, one control step is one CUDA graph (`graphs.py`) that reads
    the step's goal and writes its results at a step index kept on the
    device, and carries the solver state, plant state and clock in the
    graph's own buffers; the loop replays it once per step and reads nothing
    on the host (`host_syncs` is 0).  Goals and results pass through the
    graph's buffers `STEPS_PER_LOAD` steps at a time (device-to-device
    copies between the replays);
  * on the CPU, a Python loop over the same step, whose only host reads are
    the solver's exit-flag reads (`host_syncs`).
The tracking error is computed from the per-step states after the loop, in
one batched FK call.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils import _pytree as pytree

from parallel_ddp_tpu_torch import graphs
from parallel_ddp_tpu_torch.config import CostWeights, weights_tensor
from parallel_ddp_tpu_torch.mpc.driver import MPCController, MPCState, device_scalar
from parallel_ddp_tpu_torch.ops.cuda_sim_chain import get_hardware_controls, make_sim_chain
from parallel_ddp_tpu_torch.solver import refuse_tf32

__all__ = ["DeviceLoopResult", "get_hardware_controls", "make_device_mpc_loop"]


class DeviceLoopResult(NamedTuple):
    x: torch.Tensor          # (T, n_state) plant state at each control step end
    ee_err: torch.Tensor     # (T,) EE xyz tracking error (if plant has ee_pos)
    J: torch.Tensor          # (T,) solve cost
    accepted: torch.Tensor   # (T,) bool
    ok: torch.Tensor         # (T,) accepted or converged/feasible
    state: MPCState          # final solver state
    host_syncs: int = 0      # exit-flag reads on the host, summed over the solves
                             # (0 on the card)


# control steps whose goals and results the card's graph holds at once
STEPS_PER_LOAD = 100


def make_device_mpc_loop(
    ctrl: MPCController,
    sim_rate_hz: float = 1000.0,
    control_period_s: float = 0.01,
    sim_integrator: int = 1,
    use_feedback: bool = True,
):
    """Build run(state, x0, t0, goals, weights) -> DeviceLoopResult.

    goals: a goal pytree of the cost family's (a dict such as "ee_goal" and
    "x_target", or a bare tensor) whose tensors have a leading (T,) axis;
    entry i is active during control step i (the figure-8 goal handler
    pattern, LCM_fig8_examples.cu:140-190).  T control steps of
    `control_period_s`, each containing round(control_period * sim_rate)
    plant substeps.  Every tensor lives on the device of `state`.  The
    weights are a device tensor of the graph, loaded each call: a new value
    makes no new capture."""
    plant = ctrl.plant
    sim_dt = 1.0 / sim_rate_hz
    substeps = max(1, int(round(control_period_s * sim_rate_hz)))
    chain = make_sim_chain(plant, sim_integrator, sim_dt)
    has_ee = plant.ee_pos is not None
    n_pos, dt = plant.n_pos, ctrl.cfg.dt
    cache = graphs.GraphCache("control_step")

    def control_step(st, x, t, goal, w):
        """One control step: (new state, step info, plant state and clock at
        the period's end)."""
        st, info = ctrl._mpc_step(st, x, t, goal, w, ctrl.mpc.max_iters_per_solve)
        x_sub, t = chain.runner(st.x, st.u, st.K, st.t0, dt, t, x, substeps, use_feedback)
        return st, info, x_sub[-1], t

    def graphed_step(st, x, t, goals, i, res, w):
        """The captured step: reads goal i, writes result i, carries the
        state, plant state and clock in place, and advances i."""
        goal = pytree.tree_map(lambda v: v.index_select(0, i)[0], goals)
        st_new, info, x_new, t_new = control_step(st, x, t, goal, w)
        for held, new in zip(st, st_new):
            held.copy_(new)
        x.copy_(x_new)
        t.copy_(t_new)
        for buf, value in zip(res, (x_new, info.J, info.accepted, info.ok)):
            buf.index_copy_(0, i, value.reshape((1,) + buf.shape[1:]))
        i.add_(1)

    def run_graphed(st, x, t, goals, w, out):
        T = out[0].shape[0]
        rows = min(T, STEPS_PER_LOAD)
        example = (st, x, t,
                   pytree.tree_map(lambda v: v[:1].expand((STEPS_PER_LOAD,) + v.shape[1:]), goals),
                   torch.zeros(1, dtype=torch.int64, device=x.device),
                   tuple(o[:1].expand((STEPS_PER_LOAD,) + o.shape[1:]) for o in out), w)
        graph = cache.get(graphs.signature(example), graphed_step, example)
        s_st, s_x, s_t, s_goals, s_i, s_res, s_w = graph.args
        for held, new in zip(s_st, st):
            held.copy_(new)
        s_x.copy_(x)
        s_t.copy_(t)
        s_w.copy_(w)
        for j in range(0, T, rows):
            m = min(rows, T - j)
            for held, v in zip(pytree.tree_leaves(s_goals), pytree.tree_leaves(goals)):
                held[:m].copy_(v[j:j + m])
            s_i.zero_()
            for _ in range(m):
                graph.replay()
            for o, buf in zip(out, s_res):
                o[j:j + m].copy_(buf[:m])
        return MPCState(*(a.clone() for a in s_st))

    def run(st: MPCState, x0, t0, goals, weights: Optional[CostWeights] = None):
        dev = st.x.device
        w = weights_tensor(weights, dev)
        x = torch.as_tensor(x0, dtype=torch.float32, device=dev)
        t = device_scalar(t0, dev)
        T = pytree.tree_leaves(goals)[0].shape[0]
        f32 = dict(dtype=torch.float32, device=dev)
        out = (torch.empty((T, plant.n_state), **f32), torch.empty(T, **f32),
               torch.empty(T, dtype=torch.bool, device=dev),
               torch.empty(T, dtype=torch.bool, device=dev))
        syncs = 0
        if graphs.replayed(dev):
            refuse_tf32(dev)
            st = run_graphed(st, x, t, goals, w, out)
        else:
            for i in range(T):
                goal = pytree.tree_map(lambda v: v[i], goals)
                st, info, x, t = control_step(st, x, t, goal, w)
                syncs += ctrl.host_syncs
                for o, value in zip(out, (x, info.J, info.accepted, info.ok)):
                    o[i] = value
        xs, js, accs, oks = out
        # the error at the end of each control step, against that step's goal
        # (a bare-array goal is the target itself, as in the reference)
        is_dict = isinstance(goals, dict)
        if has_ee:
            tgt = goals["ee_goal"] if is_dict else goals
            errs = torch.linalg.vector_norm(
                plant.ee_pos(xs[:, :n_pos])[:, :3] - tgt[:, :3], dim=-1)
        else:
            errs = torch.linalg.vector_norm(xs - (goals["x_target"] if is_dict else goals),
                                            dim=-1)
        return DeviceLoopResult(xs, errs, js, accs, oks, st, syncs)

    run.graphs = cache          # the control step's captures, one per signature
    return run
