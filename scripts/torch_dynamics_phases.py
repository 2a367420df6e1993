#!/usr/bin/env python3
"""Where one forward-dynamics step of the port's Kuka kernels spends its
cycles, on the card: the one-thread core (`csrc/kuka_soa.cuh`, which no
kernel runs: the formulas the group core is held to) and the group core
(`csrc/kuka_soa_group.cuh`, what `rollout.cu`, `rbd_jac.cu`, `qdd.cu` and,
through `csrc/kuka_chain_group.cuh`, `sim_chain.cu` run: one thread in each of
9 warps per evaluation).

Builds a small source of its own against those headers with phase clocks on
(-DKUKA_PHASE_CLOCKS, -DKG_PHASE_CLOCKS), runs 16 dependent Euler steps of one
seeded state with each core and prints the mean SM cycles per phase over the
steps after the first and over 20 launches.  In the one-thread core the
phases are marks in straight-line code, which the compiler may move work
across: read its split as approximate.  In the group core the phases are
separated by block barriers; each warp's time of leaving a phase is printed,
so the longest role of a phase shows (warp 0: link 6, then the backward sweep,
then the solve; 1: the composite inertias; 2: column walks; 3, 4, 6, 8: links
5..2; 7: links 0 and 1, then more walks; 5: idle), and where each role
finishes its pieces.  Needs an NVIDIA GPU and nvcc; imports
torch, numpy and the port only.  Run from the root of a checkout:

    python3 scripts/torch_dynamics_phases.py [one|group|both|micro] [extra nvcc flags]

`micro` runs neither core but what they are made of, in one lone warp: cycles
per dependent 3x3 product with and without shared-memory traffic and a fence,
per IEEE division and per square root and reciprocal: what a role of the
group core can reach at best, and what a hand-over between warps costs.
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
from parallel_ddp_tpu_torch.ops.cuda_rbd import consts_tensor  # noqa: E402

STEPS = 16
ONE_PHASES = ("14 sin/cos", "RNEA forward sweep + link forces", "RNEA backward sweep",
              "CRBA (composites + column walks)", "Cholesky factor", "two substitutions",
              "Euler update")
GROUP_PHASES = ("sin/cos + barrier", "sweeps (RNEA | composites | column walks)",
                "barrier + Cholesky and solves", "barrier + Euler update")
GROUP_WARPS = 9           # KG_WARPS of kuka_soa_group.cuh
N_GROUP_CLOCKS = 5        # its KG_N_CLOCKS stage boundaries and the end of the step
N_MARKS = 32              # its KG_N_MARKS
MARKS = (("link 0..6's force written", range(0, 7)),
         ("bias torques written (backward sweep done)", (8,)),
         ("composite of level 5..0 written", range(15, 9, -1)),
         ("column 6..1's walk done", range(26, 20, -1)))

ONE_SRC = r"""
#include <cuda_runtime.h>
#define KUKA_PHASE_CLOCKS
#include "kuka_soa.cuh"

// 32 threads on the same state: thread 0's clocks are kept
__global__ void one_thread_kernel(const float* __restrict__ cc, const float* __restrict__ x0,
                                  const float* __restrict__ u, long long* clk, float* xout,
                                  int steps, float h) {
  float x[14], tau[7];
  for (int i = 0; i < 14; ++i) x[i] = x0[i];
  for (int i = 0; i < 7; ++i) tau[i] = u[i];
  for (int s = 0; s < steps; ++s) {
    float qdd[7];
    kuka_qdd<float>(cc, x, x + 7, tau, qdd);
    if (threadIdx.x == 0)
      for (int k = 0; k < KUKA_N_CLOCKS; ++k) clk[s * 8 + k] = kuka_phase_clk[k];
    for (int i = 0; i < 7; ++i) { x[i] = x[i] + h * x[7 + i]; x[7 + i] = x[7 + i] + h * qdd[i]; }
    if (threadIdx.x == 0) clk[s * 8 + 7] = clock64();
  }
  if (threadIdx.x == 0) for (int i = 0; i < 14; ++i) xout[i] = x[i];
}

extern "C" int run_phases(const float* cc, const float* x0, const float* u, long long* clk,
                          float* xout, int steps, float h, void* stream) {
  one_thread_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(cc, x0, u, clk, xout, steps, h);
  return static_cast<int>(cudaGetLastError());
}
"""

GROUP_SRC = r"""
#include <cuda_runtime.h>
#define KG_PHASE_CLOCKS
#include "kuka_soa_group.cuh"

// every lane on the same state; lane 0 of each warp records its clocks:
// clk[s][k][w], k = 0..KG_N_CLOCKS (the last: after the update)
__global__ void __launch_bounds__(KG_THREADS)
group_kernel(const float* __restrict__ ccg, const float* __restrict__ x0,
             const float* __restrict__ u, long long* clk, long long* marks, float* xout,
             int steps, float h) {
  __shared__ float cc[KC_SIZE];
  __shared__ float ws[KG_FIELDS * KG_LANES];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < KC_SIZE; i += KG_THREADS) cc[i] = ccg[i];
  KgCol<float> col{ws + lane};
  if (w < KUKA_NJ) {
    col[KG_X + w] = x0[w];
    col[KG_X + KUKA_NJ + w] = x0[KUKA_NJ + w];
    col[KG_TAU + w] = u[w];
  }
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    long long* c = clk + s * (KG_N_CLOCKS + 1) * KG_WARPS;
    kuka_qdd_group<float>(cc, col, w, c);
    __syncthreads();
    if (w < KUKA_NJ) {
      const float qd = col[KG_X + KUKA_NJ + w];
      col[KG_X + w] = col[KG_X + w] + h * qd;
      col[KG_X + KUKA_NJ + w] = qd + h * col[KG_QDD + w];
    }
    KG_CLOCK(c, w, KG_N_CLOCKS);
    __syncthreads();
    if (threadIdx.x < KG_N_MARKS) marks[s * KG_N_MARKS + threadIdx.x] = kg_marks[threadIdx.x];
  }
  if (threadIdx.x < 14) xout[threadIdx.x] = ws[(KG_X + threadIdx.x) * KG_LANES];
}

extern "C" int run_phases(const float* cc, const float* x0, const float* u, long long* clk,
                          float* xout, int steps, float h, void* stream) {
  group_kernel<<<1, KG_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      cc, x0, u, clk, clk + steps * (KG_N_CLOCKS + 1) * KG_WARPS, xout, steps, h);
  return static_cast<int>(cudaGetLastError());
}
"""


MICRO_NAMES = ("registers only: 2 dependent 3x3 products", "+ 9 shared loads",
               "+ 9 shared stores", "+ fence, warp barrier, flag store (a hand-over)",
               "two independent chains (4 products)", "multiply-add + IEEE division",
               "IEEE square root + reciprocal + add")

MICRO_SRC = r"""
#include <cuda_runtime.h>
#include "kuka_soa.cuh"

// one warp, 64 iterations of a dependent chain per mode; clk[mode] = cycles
__global__ void micro_kernel(float* out, long long* clk, const float* in, int mode) {
  __shared__ float sm[4096];
  const int lane = threadIdx.x & 31;
  float A[3][3], R[3][3];
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) {
      A[a][b] = in[3 * a + b] + lane;
      R[a][b] = in[9 + 3 * a + b];
      sm[(3 * a + b) * 32 + lane] = R[a][b];
    }
  __syncthreads();
  const long long t0 = clock64();
  if (mode <= 3) {
    volatile int* flag = reinterpret_cast<volatile int*>(sm + 4000);
#pragma unroll 1
    for (int it = 0; it < 64; ++it) {
      float T[3][3];
      if (mode >= 1)
        for (int a = 0; a < 3; ++a)
          for (int b = 0; b < 3; ++b) R[a][b] = sm[(3 * a + b) * 32 + lane];
      m_mul(R, A, T);
      m_mul(T, R, A);
      if (mode >= 2)
        for (int a = 0; a < 3; ++a)
          for (int b = 0; b < 3; ++b) sm[(9 + (it & 1) * 9 + 3 * a + b) * 32 + lane] = A[a][b];
      if (mode == 3) {
        __threadfence_block();
        __syncwarp();
        if (lane == 0) *flag = it;
      }
    }
  } else if (mode == 4) {
    float B[3][3];
    for (int a = 0; a < 3; ++a) for (int b = 0; b < 3; ++b) B[a][b] = A[a][b] * 0.5f;
#pragma unroll 1
    for (int it = 0; it < 64; ++it) {
      float T[3][3], U[3][3];
      m_mul(R, A, T); m_mul(R, B, U); m_mul(T, R, A); m_mul(U, R, B);
    }
    for (int a = 0; a < 3; ++a) for (int b = 0; b < 3; ++b) A[a][b] += B[a][b];
  } else if (mode == 5) {
    float z = A[0][0];
    const float l = 1.5f + R[0][0] * 1e-3f;
#pragma unroll 1
    for (int it = 0; it < 64; ++it) z = (A[1][1] - l * z) / l;
    A[0][0] = z;
  } else {
    float z = 2.f + A[0][0] * 1e-3f;
#pragma unroll 1
    for (int it = 0; it < 64; ++it) z = 1.0f / sqrtf(z) + 1.5f;
    A[0][0] = z;
  }
  const long long t1 = clock64();
  float s = 0.f;
  for (int a = 0; a < 3; ++a) for (int b = 0; b < 3; ++b) s += A[a][b];
  out[threadIdx.x] = s;
  if (threadIdx.x == 0) clk[mode] = t1 - t0;
}

extern "C" int run_micro(float* out, long long* clk, const float* in, int mode, void* stream) {
  micro_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(out, clk, in, mode);
  return static_cast<int>(cudaGetLastError());
}
"""


def micro(extra, out_dir, dev):
    lib = compile_and_load("micro", MICRO_SRC, extra, out_dir, entry="run_micro", argtypes=(
        ctypes.c_void_p,) * 3 + (ctypes.c_int, ctypes.c_void_p))
    out = torch.zeros(32, device=dev)
    clk = torch.zeros(len(MICRO_NAMES), dtype=torch.int64, device=dev)
    vals = np.array([0.9 if i % 4 == 0 else 0.01 * i for i in range(18)], np.float32)
    inp = torch.as_tensor(vals, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(2):                      # the second pass runs warm
        for mode in range(len(MICRO_NAMES)):
            status = lib(out.data_ptr(), clk.data_ptr(), inp.data_ptr(), mode, stream)
            if status:
                sys.exit(f"launch failed: CUDA error {status}")
    torch.cuda.synchronize()
    print("one lone warp, cycles per iteration of a dependent chain (64 iterations):")
    for name, c in zip(MICRO_NAMES, clk.cpu().numpy()):
        print(f"  {name}: {c / 64:.1f}")


def compile_and_load(name, source, extra_flags, out_dir, entry="run_phases", argtypes=None):
    src = os.path.join(out_dir, name + ".cu")
    lib = os.path.join(out_dir, f"lib{name}.so")
    with open(src, "w") as f:
        f.write(source)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, *extra_flags, "-shared", "-I", str(build.CSRC), src,
           "-o", lib]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        sys.exit(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    for ln in (proc.stdout + proc.stderr).splitlines():
        if "registers" in ln or "spill" in ln:
            print(f"  ptxas ({name}): {ln.split('info    :')[-1].strip()}")
    fn = getattr(ctypes.CDLL(lib), entry)
    fn.argtypes = argtypes or (ctypes.c_void_p,) * 5 + (ctypes.c_int, ctypes.c_float,
                                                        ctypes.c_void_p)
    fn.restype = ctypes.c_int
    return fn


def run(fn, n_clocks, dev, reps=20):
    rng = np.random.default_rng(0)
    cc = consts_tensor(1, 0.0, dev)
    x0 = torch.as_tensor(rng.normal(0, 0.3, 14).astype(np.float32), device=dev)
    u = torch.as_tensor(rng.normal(0, 1.0, 7).astype(np.float32), device=dev)
    clk = torch.zeros((STEPS, n_clocks), dtype=torch.int64, device=dev)
    xout = torch.zeros(14, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    total = np.zeros((STEPS, n_clocks))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ms = 0.0
    for rep in range(reps + 1):
        start.record()
        status = fn(cc.data_ptr(), x0.data_ptr(), u.data_ptr(), clk.data_ptr(), xout.data_ptr(),
                    STEPS, 0.5 / 63, stream)
        end.record()
        if status:
            sys.exit(f"launch failed: CUDA error {status}")
        torch.cuda.synchronize()
        if rep:                             # the first launch warms up
            total += clk.cpu().numpy()
            ms += start.elapsed_time(end)
    return total / reps, ms / reps, xout.cpu().numpy()


def main(argv):
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    modes = ("one", "group", "both", "micro")
    which = argv[0] if argv and argv[0] in modes else "both"
    extra = [a for a in argv if a not in modes]
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; flags: {' '.join(extra) or 'none'}; {STEPS} Euler steps of one state")
    out_dir = tempfile.mkdtemp(prefix="dynamics_phases_")
    finals = {}
    if which == "micro":
        micro(extra, out_dir, dev)
    if which in ("one", "both"):
        c, ms, finals["one"] = run(compile_and_load("one_thread", ONE_SRC, extra, out_dir), 8, dev)
        d = np.diff(c, axis=1)[1:].mean(axis=0)       # steps after the first
        print(f"one-thread core: {d.sum():.0f} cycles a step ({ms * 1e3 / STEPS:.3f} us a step by "
              f"CUDA events around the launch)")
        for name, cyc in zip(ONE_PHASES, d):
            print(f"  {name}: {cyc:.0f} cycles ({100 * cyc / d.sum():.1f} %)")
    if which in ("group", "both"):
        c, ms, finals["group"] = run(compile_and_load("group", GROUP_SRC, extra, out_dir),
                                     N_GROUP_CLOCKS * GROUP_WARPS + N_MARKS, dev)
        marks = c.reshape(-1)[STEPS * N_GROUP_CLOCKS * GROUP_WARPS:].reshape(STEPS, N_MARKS)[1:]
        c = c.reshape(-1)[:STEPS * N_GROUP_CLOCKS * GROUP_WARPS]
        c = c.reshape(STEPS, N_GROUP_CLOCKS, GROUP_WARPS)[1:]
        t0 = c[:, 0, :].min(axis=1)                   # the first warp into the step
        rel = (c - t0[:, None, None]).mean(axis=0)    # (boundary, warp)
        step = (c[:, -1, :].max(axis=1) - t0).mean()
        print(f"group core: {step:.0f} cycles a step ({ms * 1e3 / STEPS:.3f} us a step by CUDA "
              f"events around the launch)")
        prev = rel[0].max()
        for k, name in enumerate(GROUP_PHASES, start=1):
            last = rel[k].max()
            print(f"  {name}: {last - prev:.0f} cycles ({100 * (last - prev) / step:.1f} %); "
                  f"warps leave it at {' '.join(f'{v:.0f}' for v in rel[k])}")
            prev = last
        # where each role finishes its pieces, from the step's start
        m = (marks - t0[:, None]).mean(axis=0)
        for label, ids in MARKS:
            print(f"    {label}: {' '.join(f'{m[k]:.0f}' for k in ids)}")
    if len(finals) == 2:
        print(f"final states of the two cores differ by at most "
              f"{np.abs(finals['one'] - finals['group']).max():.3e}")


if __name__ == "__main__":
    main(sys.argv[1:])
