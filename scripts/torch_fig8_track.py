#!/usr/bin/env python3
"""ms per control step of the port's figure-8 closed loop, chunk by chunk.

A short run for comparing two trees of the port inside one call on one card:
the closed loop of `chip_smoke.py`'s fig8 phase (device loop, 6-iteration warm
solves, 100 Hz control, 1 kHz Euler plant), a 1 s settle on the path's start,
then chunks of 100 control steps of the track, each timed by the host clock
around the synced chunk.  The host-bound loop swings by tens of percent
between processes, so run both trees in turn several times and compare the
chunks' medians.  Needs an NVIDIA GPU; imports torch, numpy and the port only.
Run from the root of a checkout:

    python3 scripts/torch_fig8_track.py [chunks, default 5]
"""

import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from parallel_ddp_tpu_torch.mpc.device_loop import make_device_mpc_loop  # noqa: E402
from parallel_ddp_tpu_torch.mpc.driver import MPCConfig, MPCController  # noqa: E402
from parallel_ddp_tpu_torch.presets import fig8_weights, kuka_ee  # noqa: E402

CHUNK = 100
N_SETTLE = 100


def main(n_chunks):
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    prob = kuka_ee(mpc_mode=True)
    cfg = dataclasses.replace(prob.cfg, pallas_riccati=True)
    ctrl = MPCController(prob.plant, prob.cost, cfg,
                         MPCConfig(max_iters_per_solve=chip_smoke.N_ITERS))
    run = make_device_mpc_loop(ctrl, sim_rate_hz=chip_smoke.FIG8_SIM_HZ,
                               control_period_s=chip_smoke.FIG8_PERIOD, sim_integrator=1)
    w = fig8_weights()
    x_init = np.zeros(14, np.float32)
    x_init[1], x_init[3], x_init[5] = np.pi / 4, -np.pi / 4, np.pi / 4
    settle = chip_smoke.fig8_goals(torch, np, np.zeros(N_SETTLE), x_init, dev)
    track = chip_smoke.fig8_goals(
        torch, np, (np.arange(n_chunks * CHUNK) + 1) * chip_smoke.FIG8_PERIOD, x_init, dev)
    st = ctrl.init_state(torch.as_tensor(x_init, device=dev), t0=0.0,
                         goal={k: v[0] for k, v in settle.items()}, weights=w)
    res = run(st, x_init, 0.0, settle, w)
    torch.cuda.synchronize()
    st, x, t = res.state, res.x[N_SETTLE - 1], N_SETTLE * chip_smoke.FIG8_PERIOD
    ms, syncs, errs = [], 0, []
    for i in range(n_chunks):
        seg = {k: v[i * CHUNK:(i + 1) * CHUNK] for k, v in track.items()}
        t0 = time.perf_counter()
        res = run(st, x, t, seg, w)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3 / CHUNK)
        st, x, t = res.state, res.x[CHUNK - 1], t + CHUNK * chip_smoke.FIG8_PERIOD
        syncs += res.host_syncs
        errs.append(res.ee_err)
    err = float(torch.cat(errs).mean())
    if not np.isfinite(err):
        sys.exit("non-finite EE error")
    print(f"fig8 track on {card}: ms per control step by {CHUNK}-step chunk "
          f"{' '.join(f'{m:.3f}' for m in ms)}; median {float(np.median(ms)):.3f}; host syncs per "
          f"step {syncs / (n_chunks * CHUNK):.2f}; average EE error {err:.4f} m", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 5)
