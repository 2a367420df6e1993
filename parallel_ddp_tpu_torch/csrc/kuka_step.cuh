// One explicit integrator step of the Kuka iiwa-14 in float, in one thread:
// the simulation-chain kernel's step (sim_chain.cu).  The rollout kernel
// (rollout.cu) spreads the same formulas over a thread group.
#pragma once

#include "kuka_soa.cuh"

#define KUKA_NS (2 * KUKA_NJ)

// one integrator step in float (ops/integrators.py make_step, formula for formula)
__device__ __forceinline__ void kuka_step(const float* __restrict__ cc, int integrator, float h,
                                          float h_half, float h_sixth, const float x[KUKA_NS],
                                          const float u[KUKA_NJ], float xn[KUKA_NS]) {
  float k1[KUKA_NS];
  kuka_xdot<float>(cc, x, u, k1);
  if (integrator == 1) {
#pragma unroll
    for (int i = 0; i < KUKA_NS; ++i) xn[i] = x[i] + h * k1[i];
    return;
  }
  float xm[KUKA_NS], k2[KUKA_NS];
#pragma unroll
  for (int i = 0; i < KUKA_NS; ++i) xm[i] = x[i] + h_half * k1[i];
  kuka_xdot<float>(cc, xm, u, k2);
  if (integrator == 2) {
#pragma unroll
    for (int i = 0; i < KUKA_NS; ++i) xn[i] = x[i] + h * k2[i];
    return;
  }
  float k3[KUKA_NS];
#pragma unroll
  for (int i = 0; i < KUKA_NS; ++i) xm[i] = x[i] + h * (2.0f * k2[i] - k1[i]);
  kuka_xdot<float>(cc, xm, u, k3);
#pragma unroll
  for (int i = 0; i < KUKA_NS; ++i) xn[i] = x[i] + h_sixth * ((k1[i] + 4.0f * k2[i]) + k3[i]);
}
