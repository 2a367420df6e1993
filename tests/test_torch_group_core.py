"""The thread-group forward dynamics of the port's CUDA kernels
(parallel_ddp_tpu_torch/csrc/kuka_soa_group.cuh) on the host.

A CUDA kernel cannot run without a card, but this header's arithmetic and
the way its roles wait for each other can: the C++ program below (HOST_SOURCE)
compiles it with the host compiler (one host thread per warp role, a
std::barrier for the block's barrier, counters for the named barriers) and
holds it against the one-thread core csrc/kuka_soa.cuh, which is
`models/kuka/soa.py::qdd_channels` formula for formula, bit for bit, in float
and in dual numbers.  The same binary is then held against the port's torch
soa dynamics through the constants it was given."""

import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from parallel_ddp_tpu_torch.models.kuka import soa
from parallel_ddp_tpu_torch.ops import cuda_rollout

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "parallel_ddp_tpu_torch" / "csrc"
STAND_IN = """#pragma once
#include <cmath>
#include <math.h>
#define __device__
#define __global__
#define __forceinline__ inline
#define __restrict__
#define __align__(n) alignas(n)
"""


HOST_SOURCE = r'''// Host emulation of the thread-group forward dynamics of the PyTorch / CUDA
// port (parallel_ddp_tpu_torch/csrc/kuka_soa_group.cuh), for this
// test: one host thread plays each warp's role for
// one evaluation, std::barrier and counters play the block and named
// barriers, and the result must equal the one-thread core's
// (csrc/kuka_soa.cuh) bit for bit, in float and in dual numbers.  Built with
// -ffp-contract=off, so neither side fuses a multiply-add.  Each float case
// is printed with the one-thread core's answer ("case" lines: q, qd, tau, qdd).
//
// usage: group_core_host <consts.bin (KC_SIZE float32)> <evaluations>
#define KG_HOST_EMULATION
#include <atomic>
#include <barrier>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

#include "cuda_runtime.h"   // the test's stand-in: empty __device__ and friends

static std::barrier<>* g_block = nullptr;
static std::atomic<int> g_bar[16];
inline void kg_sync_block() { g_block->arrive_and_wait(); }
// `threads` counts 32 for each warp, and one host thread plays a warp
inline void kg_bar_arrive(int id, int) { g_bar[id].fetch_add(1, std::memory_order_acq_rel); }
inline void kg_bar_sync(int id, int threads) {
  g_bar[id].fetch_add(1, std::memory_order_acq_rel);
  while (g_bar[id].load(std::memory_order_acquire) < threads / 32) std::this_thread::yield();
}

#include "kuka_soa_group.cuh"

static bool same(float a, float b) { return std::memcmp(&a, &b, 4) == 0; }
static bool same(const Dual& a, const Dual& b) { return same(a.v, b.v) && same(a.d, b.d); }

template <typename T>
static int mismatches(const float* cc, const T* q, const T* qd, const T* tau, int lane) {
  T ref[KUKA_NJ];
  kuka_qdd<T>(cc, q, qd, tau, ref);
  std::vector<T> ws(KG_FIELDS * KG_LANES);
  KgCol<T> col{ws.data() + lane};
  for (int i = 0; i < KUKA_NJ; ++i) {
    col[KG_X + i] = q[i];
    col[KG_X + KUKA_NJ + i] = qd[i];
    col[KG_TAU + i] = tau[i];
  }
  for (auto& g : g_bar) g.store(0);
  std::vector<std::thread> warps;
  for (int w = 0; w < KG_WARPS; ++w)
    warps.emplace_back([&, w] { kuka_qdd_group<T>(cc, col, w); });
  for (auto& t : warps) t.join();
  int bad = 0;
  for (int i = 0; i < KUKA_NJ; ++i) bad += !same(ref[i], T(col[KG_QDD + i]));
  return bad;
}

int main(int argc, char** argv) {
  if (argc != 3) return 2;
  float cc[KC_SIZE];
  FILE* f = std::fopen(argv[1], "rb");
  if (!f || std::fread(cc, sizeof(float), KC_SIZE, f) != KC_SIZE) return 2;
  std::fclose(f);
  const int reps = std::atoi(argv[2]);
  std::barrier<> block(KG_WARPS);
  g_block = &block;
  std::mt19937 rng(0);
  std::normal_distribution<float> nx(0.f, 0.5f), nu(0.f, 2.f);
  int bad = 0, n = 0;
  for (int rep = 0; rep < reps; ++rep) {
    float q[KUKA_NJ], qd[KUKA_NJ], tau[KUKA_NJ];
    for (int i = 0; i < KUKA_NJ; ++i) { q[i] = nx(rng); qd[i] = nx(rng); tau[i] = nu(rng); }
    bad += mismatches<float>(cc, q, qd, tau, rep % KG_LANES);
    ++n;
    {   // the case and the one-thread core's answer, for a check against the Python dynamics
      float out[KUKA_NJ];
      kuka_qdd<float>(cc, q, qd, tau, out);
      std::printf("case");
      for (int i = 0; i < KUKA_NJ; ++i) std::printf(" %.9g", q[i]);
      for (int i = 0; i < KUKA_NJ; ++i) std::printf(" %.9g", qd[i]);
      for (int i = 0; i < KUKA_NJ; ++i) std::printf(" %.9g", tau[i]);
      for (int i = 0; i < KUKA_NJ; ++i) std::printf(" %.9g", out[i]);
      std::printf("\n");
    }
    for (int j = 0; j < 3 * KUKA_NJ; ++j) {   // every tangent column of the Jacobian kernel
      Dual dq[KUKA_NJ], dqd[KUKA_NJ], dtau[KUKA_NJ];
      for (int i = 0; i < KUKA_NJ; ++i) {
        dq[i] = Dual(q[i], j == i);
        dqd[i] = Dual(qd[i], j == KUKA_NJ + i);
        dtau[i] = Dual(tau[i], j == 2 * KUKA_NJ + i);
      }
      bad += mismatches<Dual>(cc, dq, dqd, dtau, (rep + j) % KG_LANES);
      ++n;
    }
  }
  std::printf("KG_FIELDS %d KC_SIZE %d KG_WARPS %d\n", KG_FIELDS, KC_SIZE, KG_WARPS);
  std::printf("evaluations %d mismatching outputs %d\n", n, bad);
  return bad != 0;
}
'''


@pytest.fixture(scope="module")
def host_binary(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    work = tmp_path_factory.mktemp("group_core")
    (work / "cuda_runtime.h").write_text(STAND_IN)
    (work / "group_core_host.cpp").write_text(HOST_SOURCE)
    binary = work / "group_core_host"
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-pthread", "-w", f"-I{work}", f"-I{CSRC}",
         str(work / "group_core_host.cpp"), "-o", str(binary)],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return work, binary


@pytest.mark.parametrize("gravity", [0.0, 9.81])
def test_group_core_equals_one_thread_core_bit_for_bit(host_binary, gravity):
    work, binary = host_binary
    consts = work / f"consts_{gravity}.bin"
    np.asarray(soa._consts(1, gravity).flat(), np.float32).tofile(consts)
    proc = subprocess.run([str(binary), str(consts), "12"], capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "evaluations 264 mismatching outputs 0" in proc.stdout
    # and the C++ dynamics are the port's torch soa dynamics: the same chain in
    # float32, ulps apart times cond(M) ~ 1e3 through the Cholesky solve
    cases = np.array([ln.split()[1:] for ln in proc.stdout.splitlines() if ln.startswith("case")],
                     dtype=np.float32)
    assert cases.shape == (12, 28)
    ref = soa.KukaSoA(ee_type=1, gravity=gravity).forward_dynamics(
        torch.as_tensor(cases[:, :14]), torch.as_tensor(cases[:, 14:21])).numpy()
    np.testing.assert_allclose(cases[:, 21:], ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_rollout_step_limit_follows_the_workspace(host_binary):
    """`MAX_BLOCK_STEPS` is what the rollout kernel's layout leaves of a
    block's 227 KB: workspace, constants, then 126 floats and a byte a step."""
    work, binary = host_binary
    consts = work / "consts_limit.bin"
    np.asarray(soa._consts(1, 0.0).flat(), np.float32).tofile(consts)
    out = subprocess.run([str(binary), str(consts), "0"], capture_output=True, text=True,
                         timeout=600).stdout
    fields, kc_size, _ = map(int, re.search(r"KG_FIELDS (\d+) KC_SIZE (\d+) KG_WARPS (\d+)",
                                            out).groups())
    per_step = 4 * (7 * 14 + 7 + 7 + 14) + 1
    assert cuda_rollout.MAX_BLOCK_STEPS == (232448 - 4 * (fields * 32 + kc_size)) // per_step
    limit = int(re.search(r"Nf > (\d+)", (CSRC / "rollout.cu").read_text()).group(1))
    assert limit == cuda_rollout.MAX_BLOCK_STEPS


HOST_BF16_SOURCE = r'''// Host emulation of the thread-group forward dynamics on the bfloat16 scalar
// (parallel_ddp_tpu_torch/csrc/bf16_scalar.cuh): one host thread per warp
// role, as group_core_host.cpp.  Reads evaluations (q, qd, tau: 21 floats
// each, bfloat16 values) and prints each one's qdd as bfloat16 bits.
//
// usage: group_core_bf16_host <consts.bin (KC_SIZE float32)> <inputs.bin>
#define KG_HOST_EMULATION
#include <atomic>
#include <barrier>
#include <cstdio>
#include <thread>
#include <vector>

#include "cuda_runtime.h"   // the test's stand-in: empty __device__ and friends

static std::barrier<>* g_block = nullptr;
static std::atomic<int> g_bar[16];
inline void kg_sync_block() { g_block->arrive_and_wait(); }
inline void kg_bar_arrive(int id, int) { g_bar[id].fetch_add(1, std::memory_order_acq_rel); }
inline void kg_bar_sync(int id, int threads) {
  g_bar[id].fetch_add(1, std::memory_order_acq_rel);
  while (g_bar[id].load(std::memory_order_acquire) < threads / 32) std::this_thread::yield();
}

#include "bf16_scalar.cuh"

int main(int argc, char** argv) {
  if (argc != 3) return 2;
  float cc[KC_SIZE];
  FILE* f = std::fopen(argv[1], "rb");
  if (!f || std::fread(cc, sizeof(float), KC_SIZE, f) != KC_SIZE) return 2;
  std::fclose(f);
  std::vector<float> in;
  f = std::fopen(argv[2], "rb");
  if (!f) return 2;
  float v;
  while (std::fread(&v, sizeof(float), 1, f) == 1) in.push_back(v);
  std::fclose(f);
  std::barrier<> block(KG_WARPS);
  g_block = &block;
  const int n = static_cast<int>(in.size()) / (3 * KUKA_NJ);
  for (int e = 0; e < n; ++e) {
    std::vector<Bf16> ws(KG_FIELDS * KG_LANES);
    KgCol<Bf16> col{ws.data() + e % KG_LANES};
    for (int i = 0; i < 3 * KUKA_NJ; ++i) col[KG_X + i] = Bf16(in[3 * KUKA_NJ * e + i]);
    for (auto& g : g_bar) g.store(0);
    std::vector<std::thread> warps;
    for (int w = 0; w < KG_WARPS; ++w)
      warps.emplace_back([&, w] { kuka_qdd_group<Bf16>(cc, col, w); });
    for (auto& t : warps) t.join();
    std::printf("qdd");
    for (int i = 0; i < KUKA_NJ; ++i) std::printf(" %u", static_cast<unsigned>(col[KG_QDD + i].b));
    std::printf("\n");
  }
  return 0;
}
'''


@pytest.mark.parametrize("gravity", [0.0, 9.81])
def test_bf16_group_core_equals_torch_bf16_dynamics(host_binary, gravity):
    """The group core on the bfloat16 scalar (what rollout.cu's bfloat16
    entry runs) against the torch soa dynamics on bfloat16 tensors (its
    plain version's step): every operation rounded as PyTorch rounds it, so
    the two agree bit for bit but where the host's sinf/cosf and PyTorch's
    sin/cos round a float to different bfloat16 neighbours (none in these
    cases; a few in a thousand would be that)."""
    work, _ = host_binary
    cxx = shutil.which("g++") or shutil.which("c++")
    (work / "group_core_bf16_host.cpp").write_text(HOST_BF16_SOURCE)
    binary = work / "group_core_bf16_host"
    if not binary.exists():
        proc = subprocess.run(
            [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-pthread", "-w", f"-I{work}",
             f"-I{CSRC}", str(work / "group_core_bf16_host.cpp"), "-o", str(binary)],
            capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-4000:]
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.normal(0, 0.5, (96, 14)), dtype=torch.float32).bfloat16()
    u = torch.as_tensor(rng.normal(0, 2.0, (96, 7)), dtype=torch.float32).bfloat16()
    consts = work / f"consts_bf16_{gravity}.bin"
    np.asarray(soa._consts(1, gravity).flat(), np.float32).tofile(consts)
    inputs = work / f"inputs_bf16_{gravity}.bin"
    torch.cat([x, u], dim=-1).float().numpy().tofile(inputs)
    proc = subprocess.run([str(binary), str(consts), str(inputs)], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    got = np.array([ln.split()[1:] for ln in proc.stdout.splitlines() if ln.startswith("qdd")],
                   dtype=np.uint16)
    ref = soa.KukaSoA(ee_type=1, gravity=gravity).forward_dynamics(x, u)
    assert ref.dtype == torch.bfloat16 and got.shape == (96, 7)
    np.testing.assert_array_equal(got, ref.view(torch.int16).numpy().view(np.uint16))
