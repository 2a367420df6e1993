#!/usr/bin/env python3
"""The forward-dynamics kernels of the PyTorch / CUDA port alone on one GPU,
written so that two trees can be compared in one call, in turn:

    python3 scripts/torch_chain_timing.py [TREE]

TREE (default: this checkout) is the root of the checkout whose
`parallel_ddp_tpu_torch` is timed, e.g. a parent commit unpacked with
`git archive` under `build/` (ignored by git, copied to the card).  Only the
wrappers are called (`ops/cuda_sim_chain.py`, `ops/cuda_rbd.py`), on seeded
inputs at the shapes of the port's paths:

  * the chain kernel (`csrc/sim_chain.cu`), open loop: the MPC warm start's
    63 Euler steps from one state, the cold rollout's 4 blocks of 16, 15 RK3
    steps, the fleet warm start's 256 chains of 63 and the batched cold
    rollout's 1,024 chains of 16; runner mode: the closed loop's 10 substeps
    at 1 kHz under the control law of a 64-knot plan;
  * the forward-dynamics kernel (`csrc/qdd.cu`) at B = 1, 2,646 (the FD
    Jacobian) and 8,192;
  * where the tree's wrappers take `ahead`, the Euler chains on the in-step
    schedule too.

Each: the kernel alone and the wrapper's host cost, by the tree's own
`chip_smoke.host_and_kernel_us` (CUDA events around replays of a CUDA graph
that captured 20 launches, no counting node: us a launch, the graph's gap
between launches included; host clock around 500 back-to-back calls, no
sync).  Prints the card line and one JSON line.
"""

import inspect
import json
import os
import subprocess
import sys

ROOT = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from parallel_ddp_tpu_torch.ops import build, cuda_rbd, cuda_sim_chain  # noqa: E402

DT, SIM_DT, N_KNOTS, ENQUEUES = 0.5 / 63, 0.001, 64, 500


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    build.library()
    build.prepare_counters(dev)
    rng = np.random.default_rng(0)
    f32 = lambda *shape, s=1.0: torch.as_tensor(rng.normal(0, s, shape).astype(np.float32),
                                                device=dev)
    has_ahead = "ahead" in inspect.signature(cuda_sim_chain.kuka_open_loop_cuda).parameters
    out = {}

    def record(name, steps, fn):
        host_us, kernel_us = chip_smoke.host_and_kernel_us(fn, ENQUEUES)
        out[name] = dict(kernel_us=kernel_us, us_per_step=kernel_us / steps, host_us=host_us)
        print(f"{name}: kernel alone {kernel_us:.2f} us ({kernel_us / steps:.3f} us a step), "
              f"host {host_us:.2f} us per enqueue", flush=True)

    for name, integ, lead, T in (("warm_start_63", 1, (1,), 63), ("cold_rollout_4x16", 1, (4,), 16),
                                 ("rk3_15", 3, (1,), 15), ("fleet_256x63", 1, (256,), 63),
                                 ("batched_cold_1024x16", 1, (1024,), 16)):
        x0, u = f32(*lead, 14, s=0.3), f32(*lead, T, 7)
        kw = dict(ee_type=1, gravity=0.0, integrator=integ, dt=DT)
        record(name, T, lambda: cuda_sim_chain.kuka_open_loop_cuda(x0, u, **kw))
        if has_ahead and integ == 1:
            record(name + "_in_step", T,
                   lambda: cuda_sim_chain.kuka_open_loop_cuda(x0, u, ahead=False, **kw))
    plan = (f32(N_KNOTS, 14, s=0.3), f32(N_KNOTS, 7), f32(N_KNOTS, 7, 14, s=0.05))
    args = (*plan, torch.tensor(0.25, device=dev), DT, torch.tensor(0.2617, device=dev),
            f32(14, s=0.3), 10)
    kw = dict(ee_type=1, gravity=0.0, integrator=1, sim_dt=SIM_DT)
    record("runner_10", 10, lambda: cuda_sim_chain.kuka_runner_cuda(*args, **kw))
    if has_ahead:
        record("runner_10_in_step", 10,
               lambda: cuda_sim_chain.kuka_runner_cuda(*args, ahead=False, **kw))
    for B in (1, 2 * 21 * 63, 8192):
        x, u = f32(B, 14, s=0.5), f32(B, 7, s=2.0)
        record(f"qdd_{B}", 1, lambda: cuda_rbd.kuka_qdd_cuda(x, u, 1, 9.81))
    print(f"card: {card}", flush=True)
    print(json.dumps({"tree": ROOT, "card": card, "times": out}), flush=True)


if __name__ == "__main__":
    main()
