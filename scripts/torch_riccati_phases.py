#!/usr/bin/env python3
"""Where a step of the port's Riccati kernel spends its time, on the card.

Builds `parallel_ddp_tpu_torch/csrc/riccati.cu` with -DRIC_PHASE_CLOCKS (thread
0 of lane 0 then records clock64() at every phase boundary), launches it on
synthetic SPD inputs at the main path's shape (4 lanes x 16 steps, n = 14,
m = 7) and prints the mean SM cycles per phase over the steps after the first
and over 20 launches.  Needs an NVIDIA GPU and nvcc; imports torch and the
port only.  Run from the root of a checkout:

    python3 scripts/torch_riccati_phases.py [extra nvcc flags]
"""

import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from parallel_ddp_tpu_torch.ops import build  # noqa: E402

PHASES = ("wait for the slot + barrier 1", "refill of the ring", "P[A B], p~ + barrier 2",
          "Hq, gq + barrier 3", "Cholesky and solve (one warp)", "barrier 4",
          "outputs, carry, dJ")
SLOTS = 8


def main(extra_flags=()):
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    out_dir = tempfile.mkdtemp(prefix="riccati_phases_")
    lib_path = os.path.join(out_dir, "libriccati_clocks.so")
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-DRIC_PHASE_CLOCKS", *extra_flags, "-shared", "-I",
           str(build.CSRC), str(build.CSRC / "riccati.cu"), "-o", lib_path]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(lib_path).pddp_riccati
    fn.argtypes, fn.restype = build._SIGNATURES["pddp_riccati"], ctypes.c_int

    M, Nb, n, m = 4, 16, 14, 7
    N, nm = M * Nb, n + m
    rng = np.random.default_rng(0)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    C = rng.normal(0, 0.3, (N, nm, nm))
    H = f32(np.einsum("kij,klj->kil", C, C) + np.eye(nm))
    Cp = rng.normal(0, 0.3, (M, n, n))
    sP = f32(np.einsum("kij,klj->kil", Cp, Cp) + np.eye(n))
    sp = f32(rng.normal(0, 0.5, (M, n)))
    AB = f32(np.concatenate([rng.normal(0, 0.3, (N - 1, n, nm)), np.zeros((1, n, nm))]))
    g, d = f32(rng.normal(0, 0.5, (N, nm))), f32(rng.normal(0, 0.1, (N, n)))
    k = torch.arange(N, device=dev)
    rho = torch.full((), 1.0, device=dev)
    sizes = (N * n * n, N * n, N * m * n, N * m, N * n * n, N * n, 2 * M, M, 2, 1, 1)
    outs = [torch.empty(s, device=dev) for s in sizes]
    clocks = torch.zeros((Nb, SLOTS), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    reps = 20
    total = np.zeros((Nb, SLOTS - 1))
    for rep in range(reps + 1):
        status = fn(sP.data_ptr(), sp.data_ptr(), rho.data_ptr(), 0, AB.data_ptr(), H.data_ptr(),
                    g.data_ptr(), d.data_ptr(), k.data_ptr(), *(o.data_ptr() for o in outs),
                    1, M, Nb, n, m, N - 1, Nb, 1, 1, clocks.data_ptr(), stream)
        if status:
            sys.exit(f"launch failed: CUDA error {status}")
        torch.cuda.synchronize()
        c = clocks.cpu().numpy()
        if rep:                             # the first launch warms up
            total += np.diff(c, axis=1)
    mean = total / reps
    per_phase = mean[1:].mean(axis=0)       # steps after the first
    print(f"card: {card}; flags: {' '.join(extra_flags) or 'none'}")
    print(f"first step: {mean[0].sum():.0f} cycles; later steps: {per_phase.sum():.0f} cycles each")
    for name, cyc in zip(PHASES, per_phase):
        print(f"  {name}: {cyc:.0f} cycles ({100 * cyc / per_phase.sum():.1f} %)")
    whole = (c[-1, -1] - c[0, 0])
    print(f"whole sweep of lane 0 (last launch): {whole} cycles for {Nb} steps")


if __name__ == "__main__":
    main(sys.argv[1:])      # extra nvcc flags
