"""Simulation chains: T dependent integrator steps as ONE op, with the CUDA
kernel that runs the time loop inside one launch and its plain versions.

The reference compiles `_qdd_kernel` (`parallel_ddp_tpu/ops/pallas_rbd.py:39`)
into `lax.scan`s: the MPC warm-start re-rollout, the cold open-loop rollout
and the closed loop's plant substeps.  Here each such scan is one call of a
`SimChain`:

    open_loop(x0 (..., n), u (..., T, m)) -> xs (..., T, n)
        T steps from x0 under the given controls, every state returned;
    runner(traj_x (N, n), traj_u (N, m), traj_K (N, m, n), t0, traj_dt, t, x,
           steps, use_feedback) -> (xs (steps, n), t + steps * sim_dt)
        `steps` plant substeps under the trajectory runner's control law
        (`get_hardware_controls`) evaluated each substep from the plan and the
        plant clock t (a 0-d tensor that stays on the device).

`make_sim_chain(plant, integrator, dt)` gives the chain of any plant: the
plant's own (`Plant.sim_chain`, the Kuka "cuda" core's) or the plain loops
over `make_step`.  The Kuka's chain runs
  * on CPU tensors, the plain versions: the step repeated in a Python loop;
  * on CUDA tensors, the kernel `csrc/sim_chain.cu` (one thread per sample,
    the state in registers across the steps), or it raises.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from parallel_ddp_tpu_torch.models.base import Plant
from parallel_ddp_tpu_torch.ops import build
from parallel_ddp_tpu_torch.ops.cuda_rbd import consts_tensor
from parallel_ddp_tpu_torch.ops.cuda_rollout import NJ, NS, _kuka_step
from parallel_ddp_tpu_torch.ops.integrators import make_step


class SimChain(NamedTuple):
    open_loop: Callable
    runner: Callable


def get_hardware_controls(traj_x, traj_u, traj_K, t0, dt, t, x_meas,
                          use_feedback: bool = True):
    """Tensor twin of mpc/controls.get_hardware_controls (the reference's
    `get_hardware_controls_jax`): index the trajectory by the plant clock t
    (a 0-d tensor), FOH on x, ZOH on u/K, u = u_k - K_k (x - x_ref)
    (getHardwareControls, MPCHelpers.cuh:817-858).  Clamps at the trajectory
    end instead of failing (the loop replans every step).  The index stays a
    device tensor: no host read."""
    n = traj_x.shape[0]
    rel = (t - t0) / dt
    ind = torch.clamp(torch.floor(rel).to(torch.int64), 0, n - 2)
    frac = torch.clamp(rel - ind.to(rel.dtype), 0.0, 1.0)
    rows = torch.stack([ind, ind + 1]).reshape(2)
    x0, x1 = traj_x.index_select(0, rows)
    x_ref = (1.0 - frac) * x0 + frac * x1
    u = traj_u.index_select(0, rows[:1])[0]
    if use_feedback:
        u = u - traj_K.index_select(0, rows[:1])[0] @ (x_meas - x_ref)
    return u


def open_loop_plain(step, x0, u):
    """Plain version of the open-loop chain: `step` repeated over u's time
    axis (-2), every state stacked on that axis."""
    if u.shape[-2] == 0:
        return x0.new_empty(u.shape[:-1] + x0.shape[-1:])
    x, xs = x0, []
    for t in range(u.shape[-2]):
        x = step(x, u[..., t, :])
        xs.append(x)
    return torch.stack(xs, dim=-2)


def runner_plain(step, sim_dt, traj_x, traj_u, traj_K, t0, traj_dt, t, x, steps,
                 use_feedback: bool = True):
    """Plain version of the trajectory-runner chain: control law, one plant
    step and the clock advance, `steps` times."""
    xs = []
    for _ in range(steps):
        u = get_hardware_controls(traj_x, traj_u, traj_K, t0, traj_dt, t, x, use_feedback)
        x = step(x, u)
        t = t + sim_dt
        xs.append(x)
    return torch.stack(xs), t


def _launch(x0, u, traj, clocks, xs, t_out, batch, steps, traj_dt, sim_dt, use_feedback,
            ee_type, gravity, integrator, dt):
    cc = consts_tensor(ee_type, float(gravity), x0.device)
    ptr = lambda a: None if a is None else a.data_ptr()
    build.launch(
        "pddp_sim_chain", x0.device, cc.data_ptr(), x0.data_ptr(), ptr(u),
        ptr(traj[0]), ptr(traj[1]), ptr(traj[2]), ptr(clocks[0]), ptr(clocks[1]),
        xs.data_ptr(), ptr(t_out), batch, steps, 0 if traj[0] is None else traj[0].shape[0],
        traj_dt, sim_dt, int(use_feedback), integrator, dt, 0.5 * dt, dt / 6.0)


def kuka_open_loop_cuda(x0, u, *, ee_type: int, gravity: float, integrator: int, dt: float):
    """Launch the chain kernel in open-loop mode on CUDA tensors x0 (..., 14),
    u (..., T, 7) with the same leading dims; returns xs (..., T, 14)."""
    lead, steps = x0.shape[:-1], u.shape[-2]
    if u.shape[:-2] != lead:
        raise ValueError(f"x0 {tuple(x0.shape)} and u {tuple(u.shape)} differ in leading dims")
    if integrator not in (1, 2, 3):
        raise ValueError(f"unknown integrator {integrator}")
    xf = x0.reshape(-1, NS).contiguous()
    uf = u.reshape(-1, steps, NJ).contiguous()
    batch = xf.shape[0]
    build.check_input("x0", xf, (batch, NS))
    build.check_input("u", uf, (batch, steps, NJ))
    if uf.device != xf.device:
        raise ValueError(f"x0 on {x0.device} but u on {u.device}")
    xs = torch.empty(lead + (steps, NS), device=xf.device, dtype=torch.float32)
    if batch and steps:
        _launch(xf, uf, (None, None, None), (None, None), xs, None, batch, steps, 0.0, 0.0,
                False, ee_type, gravity, integrator, dt)
        kuka_open_loop_cuda.counter.hit(xf.device)
    return xs


kuka_open_loop_cuda.counter = build.launch_counter("sim_chain_open_loop")


def kuka_runner_cuda(traj_x, traj_u, traj_K, t0, traj_dt, t, x, steps, use_feedback=True, *,
                     ee_type: int, gravity: float, integrator: int, sim_dt: float):
    """Launch the chain kernel in trajectory-runner mode: the plan traj_x
    (N, 14), traj_u (N, 7), traj_K (N, 7, 14), its start time t0 and the plant
    clock t (0-d float32 tensors on the device, never read on the host), the
    plant state x (14,).  Returns (xs (steps, 14), the advanced clock)."""
    n_traj = traj_x.shape[0]
    if n_traj < 2 or steps < 1:
        raise ValueError(f"the runner needs a plan of >= 2 knots and >= 1 step; "
                         f"got {n_traj} knots, {steps} steps")
    if integrator not in (1, 2, 3):
        raise ValueError(f"unknown integrator {integrator}")
    build.check_input("x", x, (NS,))
    build.check_input("traj_x", traj_x, (n_traj, NS))
    build.check_input("traj_u", traj_u, (n_traj, NJ))
    build.check_input("traj_K", traj_K, (n_traj, NJ, NS))
    build.check_input("t0", t0, ())
    build.check_input("t", t, ())
    for a in (traj_x, traj_u, traj_K, t0, t):
        if a.device != x.device:
            raise ValueError("all runner inputs must be on one device")
    # one allocation: the states, then the advanced clock
    out = torch.empty(steps * NS + 1, device=x.device, dtype=torch.float32)
    xs, t_new = out[:steps * NS].view(steps, NS), out[steps * NS]
    _launch(x, None, (traj_x, traj_u, traj_K), (t0, t), xs, t_new, 1, steps, traj_dt, sim_dt,
            use_feedback, ee_type, gravity, integrator, sim_dt)
    kuka_runner_cuda.counter.hit(x.device)
    return xs, t_new


kuka_runner_cuda.counter = build.launch_counter("sim_chain_runner")


def make_kuka_sim_chain(ee_type: int, gravity: float, integrator: int, dt: float) -> SimChain:
    """The Kuka's chain for one (integrator, step): the plain versions on CPU
    tensors, the kernel on CUDA tensors (`Plant.sim_chain` of the "cuda" core)."""
    step = _kuka_step(ee_type, float(gravity), integrator, dt)
    kw = dict(ee_type=ee_type, gravity=gravity, integrator=integrator)

    def open_loop(x0, u):
        if x0.device.type == "cpu" and u.device.type == "cpu":
            return open_loop_plain(step, x0, u)
        return kuka_open_loop_cuda(x0, u, dt=dt, **kw)

    def runner(traj_x, traj_u, traj_K, t0, traj_dt, t, x, steps, use_feedback=True):
        if x.device.type == "cpu" and traj_x.device.type == "cpu":
            return runner_plain(step, dt, traj_x, traj_u, traj_K, t0, traj_dt, t, x, steps,
                                use_feedback)
        return kuka_runner_cuda(traj_x.contiguous(), traj_u.contiguous(), traj_K.contiguous(),
                                t0, traj_dt, t, x.contiguous(), steps, use_feedback,
                                sim_dt=dt, **kw)

    return SimChain(open_loop, runner)


def make_sim_chain(plant: Plant, integrator: int, dt: float) -> SimChain:
    """The plant's chain (`Plant.sim_chain`) where it ships one, else the
    plain loops over `make_step(plant, integrator, dt)`."""
    if plant.sim_chain is not None:
        return plant.sim_chain(integrator, dt)
    step = make_step(plant, integrator, dt)

    def open_loop(x0, u):
        return open_loop_plain(step, x0, u)

    def runner(traj_x, traj_u, traj_K, t0, traj_dt, t, x, steps, use_feedback=True):
        return runner_plain(step, dt, traj_x, traj_u, traj_K, t0, traj_dt, t, x, steps,
                            use_feedback)

    return SimChain(open_loop, runner)
