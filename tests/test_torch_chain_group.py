"""The simulation chain of the port's CUDA kernel (parallel_ddp_tpu_torch/
csrc/kuka_chain_group.cuh, what csrc/sim_chain.cu runs) on the host.

A CUDA kernel cannot run without a card, but the chain's arithmetic and the
way its warps wait for each other can: the C++ program below (HOST_SOURCE)
compiles the header with the host compiler, one host thread per warp of a
block (std::barrier for the block's barrier, a generation count for each
named barrier), with no fused multiply-adds, and runs one lane's chain on
both schedules: every step in step, and the Euler chain one step ahead (the
next step's mass matrix and factor beside this step's RNEA).  Each must
equal, bit for bit, a one-thread chain written with the one-thread core's
`kuka_xdot` (csrc/kuka_soa.cuh), in open-loop mode under every integrator and
in the trajectory runner's mode.  The same states are then held against the
chain's plain versions (`ops/cuda_sim_chain.open_loop_plain` / `runner_plain`
on the torch soa step) at tests/test_torch_group_core.py's tolerance for one
evaluation, 1e-5 of the largest |value|."""

import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from parallel_ddp_tpu_torch.models.kuka import soa
from parallel_ddp_tpu_torch.ops import cuda_rollout, cuda_sim_chain

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "parallel_ddp_tpu_torch" / "csrc"
STAND_IN = """#pragma once
#include <cmath>
#include <math.h>
#include <algorithm>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __restrict__
#define __align__(n) alignas(n)
"""
DT = 0.5 / 63            # the WAFR step
SIM_DT = 0.001           # the 1 kHz plant
N_TRAJ = 64
RUNNER_STEPS = 10

HOST_SOURCE = r'''// Host emulation of the simulation chain of the PyTorch / CUDA port
// (parallel_ddp_tpu_torch/csrc/kuka_chain_group.cuh), for this test: one
// host thread plays each warp of a block for one lane's chain, std::barrier
// plays the block's barrier and a generation count each named barrier, and
// the states must equal a one-thread chain on kuka_soa.cuh's kuka_xdot bit
// for bit.  Built with -ffp-contract=off, so neither side fuses a multiply-add.
//
// usage: chain_host <consts.bin> <in.bin> <out.bin> <mode a|b> <integrator>
//            <ahead 0|1> <T> <batch> <chain> <n_traj> <rows (-1: the kernel's)>
//            <feedback 0|1> <dt> <traj_dt>
// in.bin, float32: x0 (batch, 14), then mode a: u (batch, T, 7); mode b: the
// plan x (n, 14), u (n, 7), K (n, 7, 14), t0, t.  out.bin: the emulated
// chain's states (T, 14) and clock.  Exit 0 when every state and the clock
// equal the one-thread chain's.
#define KG_HOST_EMULATION
#include <barrier>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include "cuda_runtime.h"   // the test's stand-in: empty __device__ and friends

static std::barrier<>* g_block = nullptr;
struct NamedBar {
  std::mutex m;
  std::condition_variable cv;
  int count = 0;
  long gen = 0;
};
static NamedBar g_bar[16];
inline void kg_sync_block() { g_block->arrive_and_wait(); }
// `threads` counts 32 for each warp, and one host thread plays a warp; the
// last to arrive completes the barrier, bar.sync waits for that
static void bar(int id, int threads, bool wait) {
  NamedBar& b = g_bar[id];
  std::unique_lock<std::mutex> lk(b.m);
  const long gen = b.gen;
  if (++b.count == threads / 32) {
    b.count = 0;
    ++b.gen;
    b.cv.notify_all();
    return;
  }
  if (wait) b.cv.wait(lk, [&] { return b.gen != gen; });
}
inline void kg_bar_arrive(int id, int threads) { bar(id, threads, false); }
inline void kg_bar_sync(int id, int threads) { bar(id, threads, true); }

#include "kuka_chain_group.cuh"

// ---- the one-thread chain: kuka_xdot and the integrator, sample by sample ----
static void ref_step(const float* cc, int integ, float h, float h_half, float h_sixth,
                     const float x[14], const float u[7], float xn[14]) {
  float k1[14];
  kuka_xdot<float>(cc, x, u, k1);
  if (integ == 1) {
    for (int i = 0; i < 14; ++i) xn[i] = x[i] + h * k1[i];
    return;
  }
  float xm[14], k2[14];
  for (int i = 0; i < 14; ++i) xm[i] = x[i] + h_half * k1[i];
  kuka_xdot<float>(cc, xm, u, k2);
  if (integ == 2) {
    for (int i = 0; i < 14; ++i) xn[i] = x[i] + h * k2[i];
    return;
  }
  float k3[14];
  for (int i = 0; i < 14; ++i) xm[i] = x[i] + h * (2.0f * k2[i] - k1[i]);
  kuka_xdot<float>(cc, xm, u, k3);
  for (int i = 0; i < 14; ++i) xn[i] = x[i] + h_sixth * ((k1[i] + 4.0f * k2[i]) + k3[i]);
}

// get_hardware_controls at clock t, the whole vector at once
static void ref_control(const float* px, const float* pu, const float* pK, int n, float t0,
                        float traj_dt, float t, const float x[14], bool feedback, float un[7]) {
  const float rel = (t - t0) / traj_dt;
  float fi = floorf(rel);
  fi = fminf(fmaxf(fi, 0.f), (float)(n - 2));
  const int ind = (int)fi;
  float frac = rel - fi;
  frac = frac < 0.f ? 0.f : (frac > 1.f ? 1.f : frac);
  const float* uk = pu + ind * 7;
  if (!feedback) {
    for (int i = 0; i < 7; ++i) un[i] = uk[i];
    return;
  }
  const float* xa = px + ind * 14;
  const float* xb = xa + 14;
  const float w0 = 1.0f - frac;
  float dx[14];
  for (int j = 0; j < 14; ++j) dx[j] = x[j] - (w0 * xa[j] + frac * xb[j]);
  for (int i = 0; i < 7; ++i) {
    const float* Kr = pK + (ind * 7 + i) * 14;
    float fb = Kr[0] * dx[0];
    for (int j = 1; j < 14; ++j) fb = fb + Kr[j] * dx[j];
    un[i] = uk[i] - fb;
  }
}

static bool same(float a, float b) { return std::memcmp(&a, &b, 4) == 0; }

int main(int argc, char** argv) {
  if (argc != 15) return 2;
  float cc[KC_SIZE];
  FILE* f = std::fopen(argv[1], "rb");
  if (!f || std::fread(cc, sizeof(float), KC_SIZE, f) != KC_SIZE) return 2;
  std::fclose(f);
  const bool runner = argv[4][0] == 'b';
  const int integ = std::atoi(argv[5]), ahead = std::atoi(argv[6]), T = std::atoi(argv[7]);
  const int batch = std::atoi(argv[8]), chain = std::atoi(argv[9]), n = std::atoi(argv[10]);
  const int rows_arg = std::atoi(argv[11]), feedback = std::atoi(argv[12]);
  const double dt = std::strtod(argv[13], nullptr);
  const float traj_dt = (float)std::strtod(argv[14], nullptr);
  // the wrapper's step constants: dt, 0.5 dt and dt / 6 in double, rounded to float
  const float h = (float)dt, h_half = (float)(0.5 * dt), h_sixth = (float)(dt / 6.0);
  const size_t n_in = batch * 14 + (runner ? n * (14 + 7 + 98) + 2 : (size_t)batch * T * 7);
  std::vector<float> in(n_in);
  f = std::fopen(argv[2], "rb");
  if (!f || std::fread(in.data(), sizeof(float), n_in, f) != n_in) return 2;
  std::fclose(f);
  const float* x0 = in.data();
  const float* u = runner ? nullptr : x0 + batch * 14;
  const float* px = x0 + batch * 14;
  const float* pu = px + n * 14;
  const float* pK = pu + n * 7;
  const float* clocks = pK + n * 98;     // t0, t

  // the emulated block: lane `chain % 32` of every warp
  std::vector<float> xs((size_t)batch * T * 14, 0.f);
  float t_out = 0.f;
  const int rows = runner ? (rows_arg >= 0 ? rows_arg : ch_plan_rows(T, (float)dt, traj_dt, n)) : 0;
  std::vector<float> staged((size_t)rows * CH_KNOT);
  std::vector<float> ws(CH_FIELDS * KG_LANES);
  KgCol<float> col{ws.data() + chain % KG_LANES};
  std::barrier<> block(KG_WARPS);
  g_block = &block;
  std::vector<std::thread> warps;
  for (int w = 0; w < KG_WARPS; ++w)
    warps.emplace_back([&, w] {
      ChArgs a{x0, u, xs.data(), &t_out, T, h, h_half, h_sixth, runner ? (float)dt : 0.f, 0.f,
               {px, pu, pK, nullptr, nullptr, nullptr, 0, rows, n, 0.f, traj_dt, feedback}};
      if (runner)
        ch_runner_start(a, clocks, clocks + 1, staged.data(), staged.data() + rows * CH_NS,
                        staged.data() + rows * (CH_NS + KUKA_NJ), w, KG_WARPS);
      if (integ == 1 && ahead) ch_chain<1, true>(cc, col, w, a, chain, true);
      else if (integ == 1) ch_chain<1, false>(cc, col, w, a, chain, true);
      else if (integ == 2) ch_chain<2, false>(cc, col, w, a, chain, true);
      else ch_chain<3, false>(cc, col, w, a, chain, true);
    });
  for (auto& t : warps) t.join();
  const float* got = xs.data() + (size_t)chain * T * 14;

  // the one-thread chain
  int bad = 0;
  float x[14], xn[14], un[7], t = runner ? clocks[1] : 0.f;
  for (int i = 0; i < 14; ++i) x[i] = x0[chain * 14 + i];
  for (int k = 0; k < T; ++k) {
    if (runner) {
      ref_control(px, pu, pK, n, clocks[0], traj_dt, t, x, feedback, un);
      t = t + (float)dt;
    } else {
      for (int i = 0; i < 7; ++i) un[i] = u[((size_t)chain * T + k) * 7 + i];
    }
    ref_step(cc, integ, h, h_half, h_sixth, x, un, xn);
    for (int i = 0; i < 14; ++i) {
      x[i] = xn[i];
      bad += !same(x[i], got[k * 14 + i]);
    }
  }
  if (runner) bad += !same(t, t_out);
  f = std::fopen(argv[3], "wb");
  if (!f) return 2;
  std::fwrite(got, sizeof(float), (size_t)T * 14, f);
  std::fwrite(&t_out, sizeof(float), 1, f);
  std::fclose(f);
  std::printf("rows %d states %d mismatching outputs %d\n", rows, T * 14, bad);
  return bad != 0;
}
'''


@pytest.fixture(scope="module")
def host_binary(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    work = tmp_path_factory.mktemp("chain_group")
    (work / "cuda_runtime.h").write_text(STAND_IN)
    (work / "chain_host.cpp").write_text(HOST_SOURCE)
    binary = work / "chain_host"
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-pthread", "-w", f"-I{work}",
         f"-I{CSRC}", str(work / "chain_host.cpp"), "-o", str(binary)],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return work, binary


def _run(host_binary, gravity, tag, arrays, *args):
    """Run one emulated chain; returns (states (T, 14), clock, stdout)."""
    work, binary = host_binary
    consts = work / f"consts_{gravity}.bin"
    np.asarray(soa._consts(1, gravity).flat(), np.float32).tofile(consts)
    src, out = work / f"in_{tag}.bin", work / f"out_{tag}.bin"
    np.concatenate([np.asarray(a, np.float32).ravel() for a in arrays]).tofile(src)
    proc = subprocess.run([str(binary), str(consts), str(src), str(out), *map(str, args)],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    res = np.fromfile(out, np.float32)
    return res[:-1].reshape(-1, 14), res[-1], proc.stdout


def _close_to_plain(got, ref):
    ref = ref.numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("integrator,ahead,T,batch,chain,gravity", [
    (1, 0, 63, 1, 0, 0.0),     # the warm start's re-rollout, in step
    (1, 1, 63, 1, 0, 0.0),     # the same one step ahead
    (1, 1, 16, 4, 3, 9.81),    # a block of the cold rollout, kuka_joint's gravity
    (1, 1, 1, 1, 0, 0.0),      # one step: the prologue's factor and nothing ahead
    (2, 0, 12, 2, 1, 0.0),     # Midpoint
    (3, 0, 15, 1, 0, 0.0),     # RK3
    (3, 0, 8, 3, 2, 9.81),
], ids=lambda v: str(v))
def test_open_loop_chain_equals_one_thread_chain(host_binary, integrator, ahead, T, batch, chain,
                                                 gravity):
    """Mode (a): the emulated chain equals the one-thread chain bit for bit
    (the program's own check), and the plain version within 1e-5 of max|x|."""
    rng = np.random.default_rng(10 * integrator + T)
    x0 = rng.normal(0, 0.3, (batch, 14)).astype(np.float32)
    u = rng.normal(0, 1.0, (batch, T, 7)).astype(np.float32)
    got, _, out = _run(host_binary, gravity, f"a{integrator}{ahead}{T}", (x0, u), "a", integrator,
                       ahead, T, batch, chain, 0, 0, 0, repr(DT), repr(DT))
    assert f"states {T * 14} mismatching outputs 0" in out
    step = cuda_rollout._kuka_step(1, gravity, integrator, DT)
    ref = cuda_sim_chain.open_loop_plain(step, torch.as_tensor(x0[chain]),
                                         torch.as_tensor(u[chain]))
    _close_to_plain(got, ref)


def _plan(rng):
    return (rng.normal(0, 0.3, (N_TRAJ, 14)).astype(np.float32),
            rng.normal(0, 1.0, (N_TRAJ, 7)).astype(np.float32),
            rng.normal(0, 0.05, (N_TRAJ, 7, 14)).astype(np.float32))


@pytest.mark.parametrize("ahead", [0, 1], ids=["in_step", "ahead"])
@pytest.mark.parametrize("t0,t,feedback", [(0.25, 0.2617, 1), (0.25, 0.2617, 0),
                                           (0.0, 0.4995, 1), (0.3, 0.1, 1)],
                         ids=["inside", "no_feedback", "clamped_end", "clamped_start"])
def test_runner_chain_equals_one_thread_chain(host_binary, t0, t, feedback, ahead):
    """Mode (b), the cases of tests/test_torch_cuda.py's runner test: inside
    the plan, without feedback, and with the clock clamped at the plan's end
    and start; 10 substeps at 1 kHz, Euler, on both schedules: bit for bit the
    one-thread chain (states and clock), and the plain version within 1e-5."""
    rng = np.random.default_rng(5)
    plan = _plan(rng)
    x = rng.normal(0, 0.3, (1, 14)).astype(np.float32)
    clocks = np.asarray([t0, t], np.float32)
    got, t_new, out = _run(host_binary, 0.0, f"b{t0}{t}{feedback}{ahead}", (x, *plan, clocks), "b",
                           1, ahead, RUNNER_STEPS, 1, 0, N_TRAJ, -1, feedback, repr(SIM_DT),
                           repr(DT))
    assert f"states {RUNNER_STEPS * 14} mismatching outputs 0" in out
    assert "rows 4 " in out        # 9 ms of clock reach 3 knots at most, plus one of margin
    step = cuda_rollout._kuka_step(1, 0.0, 1, SIM_DT)
    ref_x, ref_t = cuda_sim_chain.runner_plain(
        step, SIM_DT, *map(torch.as_tensor, plan), torch.tensor(t0), DT, torch.tensor(t),
        torch.as_tensor(x[0]), RUNNER_STEPS, bool(feedback))
    _close_to_plain(got, ref_x)
    assert abs(float(t_new) - float(ref_t)) <= 1e-6


@pytest.mark.parametrize("integrator,ahead,steps,rows", [
    (1, 1, 63, 2),     # the pipelined chain over 63 substeps; most knots from device memory
    (1, 0, 63, -1),    # the kernel's window: 10 knots
    (3, 0, 12, 1),     # RK3 under the control law, one knot staged
])
def test_runner_chain_past_its_window(host_binary, integrator, ahead, steps, rows):
    """The runner over more substeps than knots staged: the knots outside the
    shared-memory window are read from the plan itself, with the same bits."""
    rng = np.random.default_rng(7)
    plan = _plan(rng)
    x = rng.normal(0, 0.3, (1, 14)).astype(np.float32)
    clocks = np.asarray([0.1, 0.1031], np.float32)
    got, t_new, out = _run(host_binary, 9.81, f"w{integrator}{ahead}{rows}", (x, *plan, clocks),
                           "b", integrator, ahead, steps, 1, 0, N_TRAJ, rows, 1, repr(SIM_DT),
                           repr(DT))
    assert f"states {steps * 14} mismatching outputs 0" in out
    step = cuda_rollout._kuka_step(1, 9.81, integrator, SIM_DT)
    ref_x, ref_t = cuda_sim_chain.runner_plain(
        step, SIM_DT, *map(torch.as_tensor, plan), torch.tensor(0.1), DT, torch.tensor(0.1031),
        torch.as_tensor(x[0]), steps)
    _close_to_plain(got, ref_x)
    assert abs(float(t_new) - float(ref_t)) <= 1e-6
