// Fused multiple-shooting rollout kernel: the whole forward simulation of
// every (alpha, shooting block) lane in one launch.
//
// Replaces: parallel_ddp_tpu/ops/pallas_rollout.py::_rollout_kernel
// (pallas_call at pallas_rollout.py:114), which packs the lanes into one
// (8, 128) tile and broadcasts the per-step inputs over alpha.
//
// Per lane (a, b), serially over the Nf steps k = b*Nf + t of its block:
//   u_new = u[k] - alpha_a du[k] - K[k] (x - xp[k])      (computeControlKT)
//   x     = step(x, u_new)   one Euler / Midpoint / RK3 step of the soa qdd
// except where skip[b, t] is set (by default only k = N-1, the horizon's last
// step), where u_new = u[k] and x is held (pallas_rollout.py:87,97-101).
//
// Design: one thread per lane.  It reads u, K, du and xp of its own block
// straight from device memory, so nothing is broadcast over alpha; alpha
// lanes of one block read the same addresses and share them through L1.
//
// What bounds it on the H100: at the main path (16 alphas x 4 blocks = 64
// lanes, Nf = 16) the launch is 64 threads, each running Nf dependent steps
// of a ~2k-operation dataflow (3x that for RK3).  It is latency-bound: the
// card is almost idle and the time is one thread's serial chain.  The design
// keeps that chain short by holding the state in registers across the steps
// and doing nothing else: no shared memory, no synchronisation.

#include <cuda_runtime.h>

#include "kuka_step.cuh"

#define RO_NS KUKA_NS

__global__ void rollout_kernel(const float* __restrict__ cc, const float* __restrict__ x_swept,
                               const float* __restrict__ u, const float* __restrict__ K,
                               const float* __restrict__ du, const float* __restrict__ xp,
                               const float* __restrict__ alphas,
                               const unsigned char* __restrict__ skip, float* __restrict__ xout,
                               float* __restrict__ uout, int n_alpha, int n_blocks, int nf,
                               int integrator, float h, float h_half, float h_sixth) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_alpha * n_blocks) return;
  const int a = lane / n_blocks;
  const int b = lane - a * n_blocks;
  const int N = n_blocks * nf;
  const float alpha = alphas[a];

  float xs[RO_NS];
  const float* x0 = x_swept + ((size_t)a * N + (size_t)b * nf) * RO_NS;
#pragma unroll
  for (int i = 0; i < RO_NS; ++i) xs[i] = x0[i];

  for (int t = 0; t < nf; ++t) {
    const int k = b * nf + t;
    const bool sk = skip[k] != 0;
    float dx[RO_NS], un[KUKA_NJ];
#pragma unroll
    for (int j = 0; j < RO_NS; ++j) dx[j] = xs[j] - xp[k * RO_NS + j];
#pragma unroll
    for (int i = 0; i < KUKA_NJ; ++i) {
      const float* Kr = K + ((size_t)k * KUKA_NJ + i) * RO_NS;
      float fb = Kr[0] * dx[0];
#pragma unroll
      for (int j = 1; j < RO_NS; ++j) fb = fb + Kr[j] * dx[j];
      const float unom = u[k * KUKA_NJ + i];
      un[i] = sk ? unom : (unom - alpha * du[k * KUKA_NJ + i]) - fb;
    }
    float xn[RO_NS];
    kuka_step(cc, integrator, h, h_half, h_sixth, xs, un, xn);
    float* xo = xout + ((size_t)lane * nf + t) * RO_NS;
    float* uo = uout + ((size_t)lane * nf + t) * KUKA_NJ;
#pragma unroll
    for (int i = 0; i < RO_NS; ++i) {
      xs[i] = sk ? xs[i] : xn[i];
      xo[i] = xs[i];
    }
#pragma unroll
    for (int i = 0; i < KUKA_NJ; ++i) uo[i] = un[i];
  }
}

// x_swept (A, N, 14), u (N, 7), K (N, 7, 14), du (N, 7), xp (N, 14),
// alphas (A), skip (M, Nf) bytes -> xout (A, M, Nf, 14), uout (A, M, Nf, 7).
// h, h_half, h_sixth: dt, 0.5*dt and dt/6, rounded to float by the caller.
extern "C" int pddp_rollout(const float* consts, const float* x_swept, const float* u,
                            const float* K, const float* du, const float* xp,
                            const float* alphas, const unsigned char* skip, float* xout,
                            float* uout, int n_alpha, int n_blocks, int nf, int integrator,
                            float h, float h_half, float h_sixth, void* stream) {
  const int lanes = n_alpha * n_blocks;
  if (lanes <= 0 || nf <= 0) return 0;
  const int threads = 32;
  const int blocks = (lanes + threads - 1) / threads;
  rollout_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      consts, x_swept, u, K, du, xp, alphas, skip, xout, uout, n_alpha, n_blocks, nf, integrator,
      h, h_half, h_sixth);
  return static_cast<int>(cudaGetLastError());
}
