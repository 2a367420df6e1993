// Forward-dynamics kernel: qdd = M^{-1}(tau - C) (B, 7) of the Kuka iiwa-14
// for a batch of samples x (B, 14), u (B, 7).
//
// Replaces: parallel_ddp_tpu/ops/pallas_rbd.py::_qdd_kernel (pallas_call at
// pallas_rbd.py:86), which runs soa.qdd_channels on (8, 128) lane tiles of
// 1024 samples, one scalar channel per VMEM tile.
//
// Design: one thread per sample runs kuka_qdd<float> (kuka_soa.cuh, the
// chain the simulation-chain kernel steps) entirely in registers: it
// reads 84 bytes and writes 28 bytes per sample, and no intermediate of the
// ~2k-operation chain leaves the thread.  The TPU's lane tiling has no
// counterpart here: a warp's 32 samples are its lanes.
//
// What bounds it on the H100: at the closed loop's B = 1 (one plant or
// warm-start step at a time) the launch is one thread, so its time is the
// launch latency plus one serial chain.  At B = 8192 (the batched dynamics
// benchmark) it is 8192 threads, 64 to a block, so 128 blocks spread over
// the 132 SMs; each thread's chain is latency-bound (dependent float ops,
// register pressure), not bandwidth-bound (~1 MB moved in all).

#include <cuda_runtime.h>

#include "kuka_soa.cuh"

#define QDD_NX (2 * KUKA_NJ)

__global__ void qdd_kernel(const float* __restrict__ cc, const float* __restrict__ x,
                           const float* __restrict__ u, float* __restrict__ qdd, int batch) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  float q[KUKA_NJ], qd[KUKA_NJ], tau[KUKA_NJ], out[KUKA_NJ];
#pragma unroll
  for (int i = 0; i < KUKA_NJ; ++i) {
    q[i] = x[b * QDD_NX + i];
    qd[i] = x[b * QDD_NX + KUKA_NJ + i];
    tau[i] = u[b * KUKA_NJ + i];
  }
  kuka_qdd<float>(cc, q, qd, tau, out);
#pragma unroll
  for (int i = 0; i < KUKA_NJ; ++i) qdd[b * KUKA_NJ + i] = out[i];
}

extern "C" int pddp_qdd(const float* consts, const float* x, const float* u, float* qdd,
                        int batch, void* stream) {
  if (batch <= 0) return 0;
  const int threads = 64;
  const int blocks = (batch + threads - 1) / threads;
  qdd_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(consts, x, u, qdd, batch);
  return static_cast<int>(cudaGetLastError());
}
