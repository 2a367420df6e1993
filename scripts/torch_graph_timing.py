#!/usr/bin/env python3
"""End-to-end times of the PyTorch / CUDA port on one GPU, written so that two
trees can be compared in one call, in turn.

    python3 scripts/torch_graph_timing.py [TREE]

TREE (default: this checkout) is the root of the checkout whose
`parallel_ddp_tpu_torch` is timed, e.g. a parent commit unpacked with
`git archive` under `build/` (ignored by git, copied to the card).  Only the
public entry points are called (`make_ilqr_solver`, `MPCController`,
`make_device_mpc_loop`), so the same script times an eager tree and a
graphed one.  Measured, all on the configurations of chip_smoke.py:

  * the warm 6-iteration WAFR re-solve (the cold solve's output toward the
    next figure-8 goal): median of 20 solves, CUDA events around each;
  * the MPC step from the settled figure-8 state: median of 20, CUDA events;
  * the figure-8 closed loop after a 1 s settle: ms per control step, host
    clock around each synced 100-step chunk of the track (4 chunks);
  * torch.profiler over one warm solve and one control step: device time,
    kernels run on the card and the busy share.

Prints the card line and one JSON line.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from parallel_ddp_tpu_torch.mpc.device_loop import make_device_mpc_loop  # noqa: E402
from parallel_ddp_tpu_torch.mpc.driver import MPCConfig, MPCController  # noqa: E402
from parallel_ddp_tpu_torch.presets import ee_goal, fig8_weights, figure8_goal, kuka_ee  # noqa: E402
from parallel_ddp_tpu_torch.solver import make_ilqr_solver  # noqa: E402

N_ITERS, N_TIMED, PERIOD, SIM_HZ, CHUNK, N_CHUNKS, N_SETTLE = 6, 20, 0.01, 1000.0, 100, 4, 100


def event_ms(fn, reps):
    """Median ms of fn over reps calls, CUDA events around each."""
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def profiled(fn):
    """(device ms, operations run on the card, wall ms) of one call of fn."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    device = sum(getattr(e, "self_device_time_total", 0) for e in events) / 1e3
    ops = sum(e.count for e in events if e.device_type == DeviceType.CUDA)
    return device, ops, wall


def goals_at(times, x_init, dev):
    xyz = np.stack([figure8_goal(t, 10.0)[0] for t in times])
    g = np.concatenate([xyz, np.zeros_like(xyz)], axis=1).astype(np.float32)
    return {"ee_goal": torch.as_tensor(g, device=dev),
            "x_target": torch.as_tensor(np.tile(x_init, (len(times), 1)), device=dev)}


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()

    prob = kuka_ee()
    cfg = dataclasses.replace(prob.cfg, max_iter=N_ITERS, tol_cost=0.0, pallas_riccati=True)
    solver = make_ilqr_solver(prob.plant, prob.cost, cfg)
    x_start = (np.random.default_rng(0).standard_normal(14) * 0.3).astype(np.float32)
    x0 = torch.as_tensor(np.broadcast_to(x_start, (64, 14)).copy(), device=dev)
    cold = solver(x0, torch.zeros(64, 7, device=dev), ee_goal([0.0, -0.55, 0.35], device=dev),
                  initial_rollout=True)
    goal1 = ee_goal(list(figure8_goal(0.01)[0]), device=dev)

    def warm_solve():
        return solver(cold.x, cold.u, goal1, P0=cold.P, p0=cold.p, d0=cold.d)

    for _ in range(3):
        warm_solve()
    warm_ms = event_ms(warm_solve, N_TIMED)

    ctrl = MPCController(prob.plant, prob.cost, dataclasses.replace(prob.cfg, pallas_riccati=True),
                         MPCConfig(max_iters_per_solve=N_ITERS))
    run = make_device_mpc_loop(ctrl, sim_rate_hz=SIM_HZ, control_period_s=PERIOD,
                               sim_integrator=1)
    w = fig8_weights()
    x_init = np.zeros(14, np.float32)
    x_init[1], x_init[3], x_init[5] = np.pi / 4, -np.pi / 4, np.pi / 4
    settle = goals_at(np.zeros(N_SETTLE), x_init, dev)
    track = goals_at((np.arange(N_CHUNKS * CHUNK) + 1) * PERIOD, x_init, dev)
    st = ctrl.init_state(torch.as_tensor(x_init, device=dev), t0=0.0,
                         goal={k: v[0] for k, v in settle.items()}, weights=w)
    res = run(st, x_init, 0.0, settle, w)
    torch.cuda.synchronize()
    st, x, t = res.state, res.x[-1], torch.full((), N_SETTLE * PERIOD, device=dev)
    goal0 = {k: v[0] for k, v in track.items()}
    for _ in range(3):
        ctrl.step(st, x, t, goal0, w)
    step_ms = event_ms(lambda: ctrl.step(st, x, t, goal0, w), N_TIMED)
    one = {k: v[:1] for k, v in track.items()}
    control_step = lambda: run(st, x, t, one, w)
    chunk_ms, errs = [], []
    for i in range(N_CHUNKS):
        seg = {k: v[i * CHUNK:(i + 1) * CHUNK] for k, v in track.items()}
        t0 = time.perf_counter()
        res = run(st, x, t, seg, w)
        torch.cuda.synchronize()
        chunk_ms.append((time.perf_counter() - t0) * 1e3 / CHUNK)
        st, x, t = res.state, res.x[-1], t + CHUNK * PERIOD
        errs.append(res.ee_err)
    solve_prof = profiled(warm_solve)
    step_prof = profiled(control_step)
    print(f"card: {card}", flush=True)
    print(json.dumps({
        "tree": ROOT, "warm_solve_ms": warm_ms, "mpc_step_ms": step_ms,
        "control_step_ms_by_chunk": chunk_ms, "control_step_ms": float(np.median(chunk_ms)),
        "ee_err_mean_m": float(torch.cat(errs).mean()),
        "warm_solve_profile": dict(zip(("device_ms", "device_ops", "wall_ms"), solve_prof)),
        "control_step_profile": dict(zip(("device_ms", "device_ops", "wall_ms"), step_prof)),
    }), flush=True)


if __name__ == "__main__":
    main()
