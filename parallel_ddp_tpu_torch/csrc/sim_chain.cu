// Simulation-chain kernel: T dependent integrator steps of the Kuka iiwa-14
// per sample in ONE launch, with the time loop inside the kernel.
//
// Replaces: parallel_ddp_tpu/ops/pallas_rbd.py::_qdd_kernel (pallas_call at
// pallas_rbd.py:86) where the reference calls it inside a lax.scan that XLA
// compiles into one program: the MPC warm-start re-rollout
// (mpc/driver.py:_warm_start), the cold open-loop rollout
// (solver.open_loop_rollout) and the plant substeps of the closed loop
// (mpc/device_loop.py, the substep scan).  qdd.cu stays for batched single
// evaluations of the dynamics.
//
// Two control sources, selected by the arguments:
//   (a) open loop (u != null): sample b applies u[b, t] at step t;
//   (b) trajectory runner (u == null, one sample): each substep evaluates the
//       control law of mpc/device_loop.py::get_hardware_controls from the
//       plan (traj_x, traj_u, traj_K, t0, traj_dt) and the plant clock t:
//       index clamp, first-order hold on x, zero-order hold on u and K,
//       u = u_k - K_k (x - x_ref); then integrates and advances the clock by
//       sim_dt.  t0 and t are read from device memory, so the host reads
//       nothing; the advanced clock is written to t_out.
// Every intermediate state is written: xs (B, T, 14).
//
// Design: one thread per sample; the state stays in registers across the T
// steps and each step is kuka_step (kuka_step.cuh).  The kernel is instantiated per integrator, so the Euler chain holds
// one copy of the dynamics, not three (fewer registers spilled).  Per step
// the thread reads 28 bytes of control (mode a) or ~0.6 KB of plan (mode b)
// and writes 56 bytes of state.
//
// What bounds it on the H100: at the closed loop's shapes (one sample, T = 63
// or 10) the launch is ONE thread running T dependent ~2k-operation chains:
// it is latency-bound by that serial chain, far above the roofline's bytes
// bound (a few KB).  What the design does about it is remove everything else
// from the chain: no launch, no allocation and no host work between steps.

#include <cuda_runtime.h>

#include "kuka_step.cuh"

template <int INTEGRATOR>
__global__ void sim_chain_kernel(const float* __restrict__ cc, const float* __restrict__ x0,
                                 const float* __restrict__ u, const float* __restrict__ traj_x,
                                 const float* __restrict__ traj_u,
                                 const float* __restrict__ traj_K,
                                 const float* __restrict__ t0_ptr,
                                 const float* __restrict__ t_ptr, float* __restrict__ xs,
                                 float* __restrict__ t_out, int batch, int T, int n_traj,
                                 float traj_dt, float sim_dt, int use_feedback, float h,
                                 float h_half, float h_sixth) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const bool runner = (u == nullptr);

  float x[KUKA_NS];
#pragma unroll
  for (int i = 0; i < KUKA_NS; ++i) x[i] = x0[(size_t)b * KUKA_NS + i];
  float t = 0.f, t0 = 0.f;
  if (runner) {
    t = t_ptr[0];
    t0 = t0_ptr[0];
  }

  for (int s = 0; s < T; ++s) {
    float un[KUKA_NJ];
    if (!runner) {
      const float* us = u + ((size_t)b * T + s) * KUKA_NJ;
#pragma unroll
      for (int i = 0; i < KUKA_NJ; ++i) un[i] = us[i];
    } else {
      // get_hardware_controls: the plan's index from the plant clock, clamped
      // to [0, n_traj - 2] (a NaN clock indexes row 0, as the cast does there)
      const float rel = (t - t0) / traj_dt;
      float fi = floorf(rel);
      fi = fminf(fmaxf(fi, 0.f), (float)(n_traj - 2));
      const int ind = (int)fi;
      float frac = rel - fi;
      frac = frac < 0.f ? 0.f : (frac > 1.f ? 1.f : frac);
      const float* uk = traj_u + (size_t)ind * KUKA_NJ;
      if (use_feedback) {
        const float* xa = traj_x + (size_t)ind * KUKA_NS;
        const float* xb = xa + KUKA_NS;
        const float w0 = 1.0f - frac;
        float dx[KUKA_NS];
#pragma unroll
        for (int j = 0; j < KUKA_NS; ++j) dx[j] = x[j] - (w0 * xa[j] + frac * xb[j]);
#pragma unroll
        for (int i = 0; i < KUKA_NJ; ++i) {
          const float* Kr = traj_K + ((size_t)ind * KUKA_NJ + i) * KUKA_NS;
          float fb = Kr[0] * dx[0];
#pragma unroll
          for (int j = 1; j < KUKA_NS; ++j) fb = fb + Kr[j] * dx[j];
          un[i] = uk[i] - fb;
        }
      } else {
#pragma unroll
        for (int i = 0; i < KUKA_NJ; ++i) un[i] = uk[i];
      }
      t = t + sim_dt;
    }
    float xn[KUKA_NS];
    kuka_step(cc, INTEGRATOR, h, h_half, h_sixth, x, un, xn);
    float* xo = xs + ((size_t)b * T + s) * KUKA_NS;
#pragma unroll
    for (int i = 0; i < KUKA_NS; ++i) {
      x[i] = xn[i];
      xo[i] = xn[i];
    }
  }
  if (runner) t_out[0] = t;
}

// x0 (B, 14) -> xs (B, T, 14).  Mode (a): u (B, T, 7), the traj_* / t
// pointers unused.  Mode (b): u null, B = 1, traj_x (n_traj, 14), traj_u
// (n_traj, 7), traj_K (n_traj, 7, 14), t0 and t one float each on the device,
// t_out one float.  h, h_half, h_sixth: the step, 0.5*step and step/6,
// rounded to float by the caller (mode b: the step is sim_dt).
extern "C" int pddp_sim_chain(const float* consts, const float* x0, const float* u,
                              const float* traj_x, const float* traj_u, const float* traj_K,
                              const float* t0, const float* t, float* xs, float* t_out,
                              int batch, int T, int n_traj, float traj_dt, float sim_dt,
                              int use_feedback, int integrator, float h, float h_half,
                              float h_sixth, void* stream) {
  if (batch <= 0 || T <= 0) return 0;
  if (u == nullptr && (batch != 1 || n_traj < 2 || traj_x == nullptr || traj_u == nullptr ||
                       traj_K == nullptr || t0 == nullptr || t == nullptr || t_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (integrator < 1 || integrator > 3) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 32;
  const int blocks = (batch + threads - 1) / threads;
  auto kern = integrator == 1 ? sim_chain_kernel<1>
                              : (integrator == 2 ? sim_chain_kernel<2> : sim_chain_kernel<3>);
  kern<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      consts, x0, u, traj_x, traj_u, traj_K, t0, t, xs, t_out, batch, T, n_traj, traj_dt, sim_dt,
      use_feedback, h, h_half, h_sixth);
  return static_cast<int>(cudaGetLastError());
}
