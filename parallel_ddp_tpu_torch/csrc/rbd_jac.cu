// RBD Jacobian kernel: d qdd / d [x; u] (B, 7, 21) and the primal qdd (B, 7)
// of the Kuka iiwa-14 forward dynamics, for a batch of samples.
//
// Replaces: parallel_ddp_tpu/ops/pallas_rbd.py::_jac_kernel (pallas_call at
// pallas_rbd.py:94), which runs jax.linearize of soa.qdd_channels and applies
// the 21 unit tangents on (8, 128) lane tiles.
//
// Design: forward mode by a dual number (value, tangent) used as the scalar
// of the templated soa dynamics (kuka_soa.cuh).  One thread per (sample,
// tangent column j in 0..20): the thread seeds tangent 1 on input j,
// recomputes the primal alongside, and writes column j of the Jacobian; the
// j = 0 thread also writes the primal qdd.  This echoes the reference's
// many-threads-per-sample RBD gradient kernel.
//
// What bounds it on the H100: at the main path's B = N-1 = 63 samples the
// launch has 63 * 21 = 1323 threads, a few percent of one card, each running
// a serial ~2k-operation dataflow (about 4k flops with the tangent): it is
// latency-bound, not bandwidth- or compute-bound (it reads 84 bytes and
// writes 616 bytes per sample).  Spreading the 21 tangents over 21 threads
// is what this design does about it: the dependent chain each thread runs is
// the primal's length, not 21 times it, and the threads of a sample share
// nothing, so no synchronisation is needed.

#include <cuda_runtime.h>

#include "kuka_soa.cuh"

#define RBD_NX (2 * KUKA_NJ)
#define RBD_NIN (3 * KUKA_NJ)

__global__ void rbd_jac_kernel(const float* __restrict__ cc, const float* __restrict__ x,
                               const float* __restrict__ u, float* __restrict__ jac,
                               float* __restrict__ qdd, int batch) {
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= batch * RBD_NIN) return;
  const int b = gid / RBD_NIN;
  const int j = gid - b * RBD_NIN;

  Dual q[KUKA_NJ], qd[KUKA_NJ], tau[KUKA_NJ], out[KUKA_NJ];
#pragma unroll
  for (int i = 0; i < KUKA_NJ; ++i) {
    q[i] = Dual(x[b * RBD_NX + i], j == i ? 1.f : 0.f);
    qd[i] = Dual(x[b * RBD_NX + KUKA_NJ + i], j == KUKA_NJ + i ? 1.f : 0.f);
    tau[i] = Dual(u[b * KUKA_NJ + i], j == RBD_NX + i ? 1.f : 0.f);
  }
  kuka_qdd<Dual>(cc, q, qd, tau, out);
#pragma unroll
  for (int i = 0; i < KUKA_NJ; ++i) jac[(b * KUKA_NJ + i) * RBD_NIN + j] = out[i].d;
  if (j == 0) {
#pragma unroll
    for (int i = 0; i < KUKA_NJ; ++i) qdd[b * KUKA_NJ + i] = out[i].v;
  }
}

// The message for a CUDA error code returned by any of the launch functions.
extern "C" const char* pddp_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

extern "C" int pddp_rbd_jac(const float* consts, const float* x, const float* u, float* jac,
                            float* qdd, int batch, void* stream) {
  if (batch <= 0) return 0;
  const int threads = 128;
  const int total = batch * RBD_NIN;
  const int blocks = (total + threads - 1) / threads;
  rbd_jac_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(consts, x, u, jac, qdd,
                                                                            batch);
  return static_cast<int>(cudaGetLastError());
}
