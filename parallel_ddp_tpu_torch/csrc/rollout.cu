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
// What bounds it on the H100: 64 lanes of Nf = 16 dependent steps, each a
// ~2k-operation dataflow: it is latency-bound by one lane's serial chain,
// 3 orders above the roofline.  The first version ran that chain in one
// thread a lane (~9 us a step).
//
// Scenarios: a batch of S independent problems (a batched solve) adds a
// scenario axis to the grid's x dimension, scenario-major (S * M blocks fit
// its 2^31 - 1; the y dimension's 65,535 would cap S): each scenario has its
// own x_swept, u, K, du and xp, and shares the alphas and the skip mask.  A
// thread block runs the same program whatever S is, so a scenario's outputs
// are those of its launch alone, bit for bit.
//
// Design: a thread block per (scenario, shooting block, chunk of up to 32
// alphas) of KG_WARPS warps; lane l of every warp works on alpha l, and the
// threads with lane l are that rollout lane's group (kuka_soa_group.cuh): the
// dynamics' roles run side by side in the warps, so a step's chain is the
// longest role of each stage, not the whole operation count.
//   * What the alphas of a shooting block share (its K, u, du, xp and skip,
//     and the chain constants) is staged into shared memory once a block.
//   * Warp w < 7 owns state elements w and 7 + w of every lane: it keeps
//     them in registers over the steps, computes row w of the feedback and
//     cos/sin of joint w in one stage, and does the integrator's update for
//     its two elements.  The stage state the group shares is in the
//     workspace column.  Four block barriers an Euler step.
//   * One instance per integrator; a skipped step (uniform over the block)
//     runs no dynamics.
//   * Outputs: each warp stores its element of 32 lanes as it is made (21
//     small stores a step, off the chain: 21.5 KB in all at the main path).
//
// bfloat16 entry (pddp_rollout_bf16, SolverConfig.bf16_rollout): the same
// kernel on the scalar Bf16 (rollout_kernel<Bf16, INTEG>): the grid, staging
// and feedback law u_new = u - alpha du - K (x - xp) stay float; each
// integrator step casts x and u_new to bfloat16 and runs every
// stage and the dynamics in bfloat16 (the group core on Bf16,
// bf16_scalar.cuh: each operation rounded before the next reads it), and
// hands x back as float.  It replaces no Pallas kernel: the JAX package
// takes the rollout off its float32 kernel under bf16_rollout
// (parallel_ddp_tpu/solver.py:124-141) and runs this step as XLA ops.  The
// workspace column holds the bfloat16 channels (half the float one's
// bytes); the lanes' float states, which the feedback reads, sit beside it.
// Bounded as the float entry, by one lane's serial chain, now with a
// rounding conversion after every operation on it: 6-7x the float entry's
// time on an H100 (PERF.md).

#include <cuda_runtime.h>

#include <type_traits>

#include "bf16_scalar.cuh"

#define RO_NS (2 * KUKA_NJ)
#define RO_STEP_FLOATS (KUKA_NJ * RO_NS + 2 * KUKA_NJ + RO_NS)  // K, u, du, xp of one step
#define RO_SMEM_LIMIT 232448                                    // 227 KB a block

// Moves the kernel's pointers to this block's scenario `scen`.
#define RO_SCENARIO_OFFSETS                                          \
  const size_t n_steps = (size_t)n_blocks * nf;                      \
  x_swept += (size_t)scen * n_alpha * n_steps * (2 * KUKA_NJ);       \
  u += (size_t)scen * n_steps * KUKA_NJ;                             \
  K += (size_t)scen * n_steps * KUKA_NJ * (2 * KUKA_NJ);             \
  du += (size_t)scen * n_steps * KUKA_NJ;                            \
  xp += (size_t)scen * n_steps * (2 * KUKA_NJ);                      \
  xout += (size_t)scen * n_alpha * n_steps * (2 * KUKA_NJ);          \
  uout += (size_t)scen * n_alpha * n_steps * KUKA_NJ;

// Stage what the alphas of shooting block b share (steps k0 .. k0 + nf - 1):
// the chain constants, and K, u, du, xp and skip of its steps.
__device__ __forceinline__ void ro_stage(const float* __restrict__ cc_g,
                                         const float* __restrict__ u,
                                         const float* __restrict__ K,
                                         const float* __restrict__ du,
                                         const float* __restrict__ xp,
                                         const unsigned char* __restrict__ skip, size_t k0,
                                         int nf, float* cc, float* sK, float* su, float* sdu,
                                         float* sxp, unsigned char* sskip) {
  for (int i = threadIdx.x; i < KC_SIZE; i += KG_THREADS) cc[i] = cc_g[i];
  for (int i = threadIdx.x; i < nf * KUKA_NJ * RO_NS; i += KG_THREADS)
    sK[i] = K[k0 * KUKA_NJ * RO_NS + i];
  for (int i = threadIdx.x; i < nf * KUKA_NJ; i += KG_THREADS) {
    su[i] = u[k0 * KUKA_NJ + i];
    sdu[i] = du[k0 * KUKA_NJ + i];
  }
  for (int i = threadIdx.x; i < nf * RO_NS; i += KG_THREADS) sxp[i] = xp[k0 * RO_NS + i];
  for (int i = threadIdx.x; i < nf; i += KG_THREADS) sskip[i] = skip[k0 + i];
}

// The lanes' float states, which the feedback law reads (x_j of a lane at
// [KG_LANES * j]): on float channels the column's own KG_X fields; on a
// narrower scalar a float copy beside it (sx), since the column holds x
// cast to that type.
__device__ __forceinline__ float* ro_states(float* sx, KgCol<float> col) { return &col[KG_X]; }
__device__ __forceinline__ float* ro_states(float* sx, KgCol<Bf16> col) { return sx; }
__device__ __forceinline__ float ro_f(float a) { return a; }
__device__ __forceinline__ float ro_f(Bf16 a) { return a.f(); }

// T: the scalar of the integrator step and the dynamics (float, or Bf16 for
// the bfloat16 entry); the feedback law is float either way.
template <typename T, int INTEG>
__global__ void __launch_bounds__(KG_THREADS)
rollout_kernel(const float* __restrict__ cc_g, const float* __restrict__ x_swept,
               const float* __restrict__ u, const float* __restrict__ K,
               const float* __restrict__ du, const float* __restrict__ xp,
               const float* __restrict__ alphas, const unsigned char* __restrict__ skip,
               float* __restrict__ xout, float* __restrict__ uout, int n_alpha, int n_blocks,
               int nf, float h, float h_half, float h_sixth) {
  constexpr bool shadow = !std::is_same<T, float>::value;
  // this block's scenario: its inputs and outputs
  const int scen = blockIdx.x / n_blocks;
  RO_SCENARIO_OFFSETS
  extern __shared__ float smem[];
  float* cc = smem;                                        // KC_SIZE
  float* sx = cc + KC_SIZE;                                // shadow: 14 x 32 float states
  T* ws = reinterpret_cast<T*>(sx + (shadow ? RO_NS * KG_LANES : 0));  // KG_FIELDS x 32
  float* sK = reinterpret_cast<float*>(ws + KG_FIELDS * KG_LANES);   // nf x 7 x 14
  float* su = sK + nf * KUKA_NJ * RO_NS;                   // nf x 7
  float* sdu = su + nf * KUKA_NJ;                          // nf x 7
  float* sxp = sdu + nf * KUKA_NJ;                         // nf x 14
  unsigned char* sskip = reinterpret_cast<unsigned char*>(sxp + nf * RO_NS);  // nf

  const int lane = threadIdx.x & (KG_LANES - 1), w = threadIdx.x >> 5;
  const int b = blockIdx.x - scen * n_blocks;
  const int a = blockIdx.y * KG_LANES + lane;
  const bool valid = a < n_alpha;
  const int ac = valid ? a : n_alpha - 1;      // spare lanes repeat the last alpha, store nothing
  const int N = n_blocks * nf;
  const size_t k0 = (size_t)b * nf;

  ro_stage(cc_g, u, K, du, xp, skip, k0, nf, cc, sK, su, sdu, sxp, sskip);

  KgCol<T> col{ws + lane};
  float* xs = ro_states(sx + lane, col);
  const float alpha = alphas[ac];
  float xq = 0.f, xv = 0.f;                    // this warp's two state elements (w < 7)
  if (w < KUKA_NJ) {
    const float* x0 = x_swept + ((size_t)ac * N + k0) * RO_NS;
    xq = x0[w];
    xv = x0[KUKA_NJ + w];
    col[KG_X + w] = T(xq);
    col[KG_X + KUKA_NJ + w] = T(xv);
    if (shadow) {
      xs[KG_LANES * w] = xq;
      xs[KG_LANES * (KUKA_NJ + w)] = xv;
    }
  }
  __syncthreads();

  float* xo = xout + (((size_t)ac * n_blocks + b) * nf) * RO_NS;
  float* uo = uout + (((size_t)ac * n_blocks + b) * nf) * KUKA_NJ;
  for (int t = 0; t < nf; ++t, xo += RO_NS, uo += KUKA_NJ) {
    const bool sk = sskip[t] != 0;             // the same for the whole block
    if (w < KUKA_NJ) {
      float un = su[t * KUKA_NJ + w];
      if (!sk) {
        const float* Kr = sK + (t * KUKA_NJ + w) * RO_NS;
        const float* xpt = sxp + t * RO_NS;
        float fb = Kr[0] * (xs[0] - xpt[0]);
#pragma unroll
        for (int j = 1; j < RO_NS; ++j) fb = fb + Kr[j] * (xs[KG_LANES * j] - xpt[j]);
        un = (un - alpha * sdu[t * KUKA_NJ + w]) - fb;
        col[KG_TAU + w] = T(un);
        kg_trig(col, w);
      }
      if (valid) uo[w] = un;
    }
    if (sk) {                                  // x is held: nothing to evaluate
      if (valid && w < KUKA_NJ) { xo[w] = xq; xo[KUKA_NJ + w] = xv; }
      continue;
    }
    __syncthreads();
    kuka_qdd_group_after_trig(cc, col, w);
    __syncthreads();
    // the integrator (ops/integrators.py make_step, formula for formula) on
    // this warp's elements, in T: xdot = [qd; qdd], x = [q; v] this step's
    // x as T (the column's KG_X)
    const T q = T(xq), v = T(xv);
    if (INTEG == 1) {
      if (w < KUKA_NJ) {
        xq = ro_f(q + h * v);
        xv = ro_f(v + h * col[KG_QDD + w]);
      }
    } else {
      T k1q(0.f), k1v(0.f), k2q(0.f), k2v(0.f);
      if (w < KUKA_NJ) {
        k1q = v;
        k1v = col[KG_QDD + w];
        col[KG_X + w] = q + h_half * k1q;
        col[KG_X + KUKA_NJ + w] = v + h_half * k1v;
      }
      __syncthreads();
      kuka_qdd_group(cc, col, w);
      __syncthreads();
      if (w < KUKA_NJ) {
        k2q = col[KG_X + KUKA_NJ + w];
        k2v = col[KG_QDD + w];
      }
      if (INTEG == 2) {
        if (w < KUKA_NJ) {
          xq = ro_f(q + h * k2q);
          xv = ro_f(v + h * k2v);
        }
      } else {
        if (w < KUKA_NJ) {
          col[KG_X + w] = q + h * (2.0f * k2q - k1q);
          col[KG_X + KUKA_NJ + w] = v + h * (2.0f * k2v - k1v);
        }
        __syncthreads();
        kuka_qdd_group(cc, col, w);
        __syncthreads();
        if (w < KUKA_NJ) {
          const T k3q = col[KG_X + KUKA_NJ + w];
          const T k3v = col[KG_QDD + w];
          xq = ro_f(q + h_sixth * ((k1q + 4.0f * k2q) + k3q));
          xv = ro_f(v + h_sixth * ((k1v + 4.0f * k2v) + k3v));
        }
      }
    }
    if (w < KUKA_NJ) {
      col[KG_X + w] = T(xq);                   // exact: xq is a T value
      col[KG_X + KUKA_NJ + w] = T(xv);
      if (shadow) {
        xs[KG_LANES * w] = xq;
        xs[KG_LANES * (KUKA_NJ + w)] = xv;
      }
      if (valid) { xo[w] = xq; xo[KUKA_NJ + w] = xv; }
    }
    __syncthreads();
  }
}

// Launch rollout_kernel<T, integrator> on the grid; the arguments are
// pddp_rollout's.
template <typename T>
static int ro_launch(const float* consts, const float* x_swept, const float* u, const float* K,
                     const float* du, const float* xp, const float* alphas,
                     const unsigned char* skip, float* xout, float* uout, int n_scen,
                     int n_alpha, int n_blocks, int nf, int integrator, float h, float h_half,
                     float h_sixth, void* stream) {
  if (n_scen <= 0 || n_alpha <= 0 || n_blocks <= 0 || nf <= 0) return 0;
  if (static_cast<long long>(n_scen) * n_blocks > 0x7fffffffLL ||
      (n_alpha + KG_LANES - 1) / KG_LANES > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (integrator < 1 || integrator > 3) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shadow = std::is_same<T, float>::value ? 0 : RO_NS * KG_LANES;
  const size_t bytes = sizeof(float) * (KC_SIZE + shadow + (size_t)nf * RO_STEP_FLOATS) +
                       sizeof(T) * KG_FIELDS * KG_LANES + nf;
  if (bytes > RO_SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = integrator == 1 ? rollout_kernel<T, 1>
                              : (integrator == 2 ? rollout_kernel<T, 2> : rollout_kernel<T, 3>);
  if (bytes > 48 * 1024) {
    cudaError_t st = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          static_cast<int>(bytes));
    if (st != cudaSuccess) return static_cast<int>(st);
  }
  const dim3 grid(n_scen * n_blocks, (n_alpha + KG_LANES - 1) / KG_LANES);
  kern<<<grid, KG_THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      consts, x_swept, u, K, du, xp, alphas, skip, xout, uout, n_alpha, n_blocks, nf, h, h_half,
      h_sixth);
  return static_cast<int>(cudaGetLastError());
}

// S scenarios: x_swept (S, A, N, 14), u (S, N, 7), K (S, N, 7, 14), du (S, N, 7),
// xp (S, N, 14), and shared alphas (A) and skip (M, Nf) bytes -> xout
// (S, A, M, Nf, 14), uout (S, A, M, Nf, 7).
// h, h_half, h_sixth: dt, 0.5*dt and dt/6, rounded to float by the caller.
// A block stages Nf steps of inputs: cudaErrorInvalidValue where they do not
// fit its shared memory (Nf > 418).
extern "C" int pddp_rollout(const float* consts, const float* x_swept, const float* u,
                            const float* K, const float* du, const float* xp,
                            const float* alphas, const unsigned char* skip, float* xout,
                            float* uout, int n_scen, int n_alpha, int n_blocks, int nf,
                            int integrator, float h, float h_half, float h_sixth, void* stream) {
  return ro_launch<float>(consts, x_swept, u, K, du, xp, alphas, skip, xout, uout, n_scen,
                          n_alpha, n_blocks, nf, integrator, h, h_half, h_sixth, stream);
}

// The bfloat16 step's entry: pddp_rollout's arguments, inputs and outputs.
extern "C" int pddp_rollout_bf16(const float* consts, const float* x_swept, const float* u,
                                 const float* K, const float* du, const float* xp,
                                 const float* alphas, const unsigned char* skip, float* xout,
                                 float* uout, int n_scen, int n_alpha, int n_blocks, int nf,
                                 int integrator, float h, float h_half, float h_sixth,
                                 void* stream) {
  return ro_launch<Bf16>(consts, x_swept, u, K, du, xp, alphas, skip, xout, uout, n_scen,
                         n_alpha, n_blocks, nf, integrator, h, h_half, h_sixth, stream);
}
