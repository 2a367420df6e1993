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
// What bounds it on the H100: at the closed loop's shapes (one sample, T = 63
// or 10) the launch is one chain of T dependent ~2k-operation dynamics
// evaluations: it is latency-bound by that serial chain, far above the
// roofline's bytes bound (a few KB).  What the design does about it:
//   * no launch, allocation or host work between steps (the time loop inside);
//   * each evaluation spread over a thread group (kuka_chain_group.cuh on
//     kuka_soa_group.cuh): a block of KG_WARPS warps takes 32 chains, lane l
//     of every warp chain l, so a step waits for the longest role of each
//     stage, not for the whole operation count; a first version ran a chain
//     in one thread (6.5 us a step, registers spilled);
//   * the Euler chain runs one step ahead: the next step's mass matrix and
//     factor under this step's RNEA and substitutions;
//   * the constants, and in mode (b) the plan's knots that the clock can
//     reach in T steps, are staged in shared memory once a block.
// One instance per integrator (and for Euler per schedule).

#include <cuda_runtime.h>

#include "kuka_chain_group.cuh"

#define SC_SMEM_LIMIT 232448                   // 227 KB a block

template <int INTEG, bool AHEAD>
__global__ void __launch_bounds__(KG_THREADS)
sim_chain_kernel(const float* __restrict__ cc_g, const float* __restrict__ x0,
                 const float* __restrict__ u, const float* __restrict__ traj_x,
                 const float* __restrict__ traj_u, const float* __restrict__ traj_K,
                 const float* __restrict__ t0_ptr, const float* __restrict__ t_ptr,
                 float* __restrict__ xs, float* __restrict__ t_out, int batch, int T, int n_traj,
                 int rows, float traj_dt, float sim_dt, int use_feedback, float h, float h_half,
                 float h_sixth) {
  extern __shared__ float smem[];
  float* cc = smem;                            // KC_SIZE
  float* ws = cc + KC_SIZE;                    // CH_FIELDS x 32
  float* sx = ws + CH_FIELDS * KG_LANES;       // rows x 14, mode (b)
  float* su = sx + rows * CH_NS;               // rows x 7
  float* sK = su + rows * KUKA_NJ;             // rows x 7 x 14

  const int lane = threadIdx.x & (KG_LANES - 1), w = threadIdx.x >> 5;
  const int b = blockIdx.x * KG_LANES + lane;
  const bool store = b < batch;

  for (int i = threadIdx.x; i < KC_SIZE; i += KG_THREADS) cc[i] = cc_g[i];
  ChArgs a{x0, u, xs, t_out, T, h, h_half, h_sixth, sim_dt, 0.f,
           {traj_x, traj_u, traj_K, nullptr, nullptr, nullptr, 0, rows, n_traj, 0.f, traj_dt,
            use_feedback}};
  if (u == nullptr) ch_runner_start(a, t0_ptr, t_ptr, sx, su, sK, threadIdx.x, KG_THREADS);
  // staged values are first read after ch_chain's first block barrier
  ch_chain<INTEG, AHEAD>(cc, KgCol<float>{ws + lane}, w, a, store ? b : batch - 1, store);
}

static int sim_chain_launch(bool ahead, const float* consts, const float* x0, const float* u,
                            const float* traj_x, const float* traj_u, const float* traj_K,
                            const float* t0, const float* t, float* xs, float* t_out, int batch,
                            int T, int n_traj, float traj_dt, float sim_dt, int use_feedback,
                            int integrator, float h, float h_half, float h_sixth,
                            void* stream) {
  if (batch <= 0 || T <= 0) return 0;
  if (u == nullptr && (batch != 1 || n_traj < 2 || traj_x == nullptr || traj_u == nullptr ||
                       traj_K == nullptr || t0 == nullptr || t == nullptr || t_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (integrator < 1 || integrator > 3) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = u == nullptr ? ch_plan_rows(T, sim_dt, traj_dt, n_traj) : 0;
  const size_t bytes = sizeof(float) * (KC_SIZE + CH_FIELDS * KG_LANES + (size_t)rows * CH_KNOT);
  if (bytes > SC_SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = integrator == 2 ? sim_chain_kernel<2, false>
              : integrator == 3 ? sim_chain_kernel<3, false>
              : ahead ? sim_chain_kernel<1, true> : sim_chain_kernel<1, false>;
  if (bytes > 48 * 1024) {
    cudaError_t st = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          static_cast<int>(bytes));
    if (st != cudaSuccess) return static_cast<int>(st);
  }
  const int blocks = (batch + KG_LANES - 1) / KG_LANES;
  kern<<<blocks, KG_THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      consts, x0, u, traj_x, traj_u, traj_K, t0, t, xs, t_out, batch, T, n_traj, rows, traj_dt,
      sim_dt, use_feedback, h, h_half, h_sixth);
  return static_cast<int>(cudaGetLastError());
}

// x0 (B, 14) -> xs (B, T, 14).  Mode (a): u (B, T, 7), the traj_* / t
// pointers unused.  Mode (b): u null, B = 1, traj_x (n_traj, 14), traj_u
// (n_traj, 7), traj_K (n_traj, 7, 14), t0 and t one float each on the device,
// t_out one float.  h, h_half, h_sixth: the step, 0.5*step and step/6,
// rounded to float by the caller (mode b: the step is sim_dt).
// cudaErrorInvalidValue where mode (b)'s staged knots would pass a block's
// shared memory (above ~420 knots in reach of the T steps).
extern "C" int pddp_sim_chain(const float* consts, const float* x0, const float* u,
                              const float* traj_x, const float* traj_u, const float* traj_K,
                              const float* t0, const float* t, float* xs, float* t_out,
                              int batch, int T, int n_traj, float traj_dt, float sim_dt,
                              int use_feedback, int integrator, float h, float h_half,
                              float h_sixth, void* stream) {
  return sim_chain_launch(true, consts, x0, u, traj_x, traj_u, traj_K, t0, t, xs, t_out, batch, T,
                          n_traj, traj_dt, sim_dt, use_feedback, integrator, h, h_half, h_sixth,
                          stream);
}

// The same chain with the Euler steps on the in-step schedule (each step's
// mass matrix and factor inside the step): what the one-step-ahead chain is
// held to, bit for bit.  Midpoint and RK3 are the same on both entry points.
extern "C" int pddp_sim_chain_in_step(const float* consts, const float* x0, const float* u,
                                      const float* traj_x, const float* traj_u,
                                      const float* traj_K, const float* t0, const float* t,
                                      float* xs, float* t_out, int batch, int T, int n_traj,
                                      float traj_dt, float sim_dt, int use_feedback,
                                      int integrator, float h, float h_half, float h_sixth,
                                      void* stream) {
  return sim_chain_launch(false, consts, x0, u, traj_x, traj_u, traj_K, t0, t, xs, t_out, batch,
                          T, n_traj, traj_dt, sim_dt, use_feedback, integrator, h, h_half,
                          h_sixth, stream);
}
