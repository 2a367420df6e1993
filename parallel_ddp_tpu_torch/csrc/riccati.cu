// Fused block-Riccati backward sweep: every backward block's serial sweep in
// one launch (one rho attempt of the backward pass).
//
// Replaces: parallel_ddp_tpu/ops/pallas_riccati.py::_riccati_kernel
// (pallas_call at pallas_riccati.py:273), which runs the time steps as a
// sequential Pallas grid with the blocks in the vector lanes.
//
// Per block lane, steps k descending within the block, with the cost-to-go
// (P, p) carried from the block's seed (parallel/backward.py
// make_riccati_step, line for line):
//   p~  = p + P d_k             where (k+1) % n_blocks_f == 0 and k < N-1
//   Hq  = H_k + [A B]^T P [A B]  (Tassa state reg: u-rows see P + rho I)
//   gq  = g_k + [A B]^T p~
//   Cholesky of Huu (+ I at the terminal step), failed pivots clamped to 1
//   K, du, P', p', A - B K, B du, the dJ terms and the fail flag
// The terminal step k = N-1 passes the seed through with zero gains.  Outputs
// are written at their own step index, so they come back in ascending k.
// dJ and fail are also reduced over each scenario's lanes here, by the last
// of its blocks to finish, in lane order (no float atomics: the sum is
// deterministic).
//
// Scenarios: a batch of S independent problems (a batched solve) is S * Mb
// lanes, scenario-major; every lane runs the same program on its own inputs,
// so a scenario's outputs do not depend on the others'.  Each scenario has
// its own ticket, dJ and fail (the reference packs scenarios into its lane
// tile the same way, pallas_riccati.py:430-477).
//
// What bounds it on the H100: at the main path there are M = 4 lanes (4
// thread blocks on 4 of the 132 SMs) and Nb = 16 dependent steps of ~10k
// flops each; the roofline's bytes bound (~0.3 MB moved) is a fraction of a
// microsecond.  It is latency-bound: the time is the serial chain of phases
// per step.  The design keeps everything else off that chain:
//   * Staged inputs.  A lane's AB, H, g and d for its steps are copied into a
//     ring of shared-memory slots with cp.async, started up front in the order
//     the sweep consumes them (last step first); a step waits only for its
//     own slot, so after the first step no device-memory latency is left on
//     the chain.  At the main path the ring holds all 16 steps (49 KB of the
//     block's 227 KB); a block too long to fit reuses the slots of finished
//     steps.
//   * Compile-time sizes.  (n, m) = (14, 7), the Kuka's, is instantiated
//     with constant sizes, so the inner loops unroll and the index divisions
//     fold; every other plant (n <= 16, m <= 8) takes the same body with
//     run-time sizes.
//   * Four block barriers per step: [wait for the slot] P[A B] and p~ |
//     Hq and gq | Cholesky and solve | outputs and the new (P, p).
//   * Product phases as wide as the block: one thread per entry and 512
//     threads, so each phase is one round at the Kuka's sizes (a phase is
//     bound by instruction dispatch and latency, not by arithmetic: strips of
//     several rows per thread on fewer threads, and rolled summation loops,
//     both measured slower).  Every output and the new (P, p) are computed
//     entry by entry from Hq and the solution, so K^T Hux and Hxu K are never
//     stored (and K^T Hux, which the plain version forms twice, is summed
//     once); (P + rho I)[A B] is formed once per step, not per use.
//   * Cholesky and solve inside one warp with no exchange between lanes:
//     lane c solves right-hand side c of Huu^-1 [Hux | gu] and, for that,
//     factors Huu itself in registers, fully unrolled (every lane the same
//     factor: the loads are broadcasts, the redundant arithmetic costs no
//     time).  The forward substitution of row j runs in the shadow of the
//     factor's sqrt / reciprocal chain.
//   * The arithmetic is the plain version's: one accumulator per entry, the
//     summation index ascending; nvcc's fused multiply-adds differ, and a
//     division by a diagonal entry of the factor goes through its reciprocal
//     with one correction step, which rounds as the division does.
// The counters of finished lanes are the caller's, one per scenario and call,
// zeroed on the launch's stream just before it: sweeps on different streams
// do not share them.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

#define RIC_NMAX 16
#define RIC_MMAX 8
#define RIC_THREADS 512

// Built with -DRIC_PHASE_CLOCKS (scripts/torch_riccati_phases.py), thread 0 of
// lane 0 records clock64() at the phase boundaries of every step into
// `clocks` (Nb, RIC_CLOCK_SLOTS); otherwise the macro is empty.
#define RIC_CLOCK_SLOTS 8
#ifdef RIC_PHASE_CLOCKS
#define RIC_CLOCK(slot) \
  if (clocks != nullptr && tid == 0 && lane == 0) clocks[i * RIC_CLOCK_SLOTS + (slot)] = clock64()
#else
#define RIC_CLOCK(slot)
#endif

// cp.async one step's inputs into a ring slot laid out [AB | H | g | d]
__device__ __forceinline__ void ric_stage(float* __restrict__ dst, const float* __restrict__ AB,
                                          const float* __restrict__ H,
                                          const float* __restrict__ G,
                                          const float* __restrict__ Dd, size_t step, int n,
                                          int nm, int tid) {
  const int nab = n * nm, nh = nm * nm;
  const float* s_ab = AB + step * nab;
  const float* s_h = H + step * nh;
  const float* s_g = G + step * nm;
  const float* s_d = Dd + step * n;
  for (int e = tid; e < nab; e += RIC_THREADS) __pipeline_memcpy_async(dst + e, s_ab + e, 4);
  for (int e = tid; e < nh; e += RIC_THREADS) __pipeline_memcpy_async(dst + nab + e, s_h + e, 4);
  for (int e = tid; e < nm; e += RIC_THREADS)
    __pipeline_memcpy_async(dst + nab + nh + e, s_g + e, 4);
  for (int e = tid; e < n; e += RIC_THREADS)
    __pipeline_memcpy_async(dst + nab + nh + nm + e, s_d + e, 4);
}

// sum over l < len of X[l * x_s] * Y[l * y_s]: one accumulator, l ascending
__device__ __forceinline__ float ric_dot(const float* X, int x_s, const float* Y, int y_s,
                                         int len) {
  float acc = X[0] * Y[0];
#pragma unroll
  for (int l = 1; l < len; ++l) acc = acc + X[l * x_s] * Y[l * y_s];
  return acc;
}

// x / d given inv = 1 / d correctly rounded: the product with one correction
// step rounds as the division does (Markstein), in 3 dependent operations.
__device__ __forceinline__ float ric_div(float x, float d, float inv) {
  const float q = x * inv;
  return fmaf(fmaf(-q, d, x), inv, q);
}

// N_ = M_ = 0: sizes from n_rt, m_rt.
template <int N_, int M_>
__global__ void __launch_bounds__(RIC_THREADS)
riccati_kernel(const float* __restrict__ seedP, const float* __restrict__ seedp,
               const float* __restrict__ rho_l, int rho_stride, const float* __restrict__ AB,
               const float* __restrict__ H, const float* __restrict__ G,
               const float* __restrict__ Dd, const long long* __restrict__ kidx,
               float* __restrict__ P_out, float* __restrict__ p_out, float* __restrict__ K_out,
               float* __restrict__ du_out, float* __restrict__ ApBK_out,
               float* __restrict__ Bdu_out, float* dj_lane, int* fail_lane, float* dj_total,
               unsigned char* fail_total, unsigned int* lanes_done, int lanes, int Nb, int n_rt,
               int m_rt, int nf, int n_blocks_f, int state_reg, int use_defect, int stages,
               long long* clocks) {
  const int lane = blockIdx.x;                 // scenario-major: scen * lanes + time block
  const int scen = lane / lanes;
  const int tblk = lane - scen * lanes;        // the time block: its step indices
  const int tid = threadIdx.x;
  const int n = N_ > 0 ? N_ : n_rt;
  const int m = M_ > 0 ? M_ : m_rt;
  const int nm = n + m;
  const int n1 = n + 1;

  const int tally = RIC_THREADS - 32;    // first thread of the last warp: dJ and fail

  extern __shared__ float smem[];
  float* P = smem;                       // (n, n) cost-to-go Hessian, carried
  float* p = P + n * n;                  // (n)
  float* pt = p + n;                     // (n) p~
  float* Pab = pt + n;                   // (n, nm) P [A B]
  float* Pabu = Pab + n * nm;            // (n, nm) (P + rho I) [A B], state reg
  float* Hq = Pabu + n * nm;             // (nm, nm)
  float* gq = Hq + nm * nm;              // (nm)
  float* sol = gq + nm;                  // (m, n1) Huu^-1 [Hux | gu]
  int* s_ok = reinterpret_cast<int*>(sol + m * n1);
  float* ring = sol + m * n1 + 1;
  const int stage_floats = n * nm + nm * nm + nm + n;

  // stage the first `stages` steps of the sweep, one cp.async group each
  for (int i = 0; i < stages; ++i) {
    ric_stage(ring + i * stage_floats, AB, H, G, Dd, (size_t)lane * Nb + (Nb - 1 - i), n, nm, tid);
    __pipeline_commit();
  }
  // group g holds sweep step g; before step i's wait, stages + i - 1 groups
  // are committed and groups 0..i must be complete
  const int allowed = stages >= 2 ? stages - 2 : 0;

  const float rho = rho_l[(size_t)lane * rho_stride];
  for (int e = tid; e < n * n; e += RIC_THREADS) P[e] = seedP[(size_t)lane * n * n + e];
  for (int e = tid; e < n; e += RIC_THREADS) p[e] = seedp[(size_t)lane * n + e];
  float dj0_acc = 0.f, dj1_acc = 0.f;   // live in thread `tally`
  int fail_acc = 0;

  long long k_next = kidx[(size_t)tblk * Nb + Nb - 1];
  int slot = 0;                          // i % stages
  for (int i = 0; i < Nb; ++i) {
    const int t = Nb - 1 - i;
    const size_t step = (size_t)lane * Nb + t;
    const int k = static_cast<int>(k_next);
    if (t > 0) k_next = kidx[(size_t)tblk * Nb + t - 1];   // in flight during this step
    const bool term = (k == nf);
    const bool dfct = use_defect && ((k + 1) % n_blocks_f == 0) && (k < nf);

    // barrier 1: this step's slot has landed for every thread, and the
    // previous step's readers and writers (P, p, its slot) are done
    RIC_CLOCK(0);
    __pipeline_wait_prior(allowed);
    __syncthreads();
    RIC_CLOCK(1);
    if (i >= 1) {
      const int i_new = i - 1 + stages;   // refill the slot the previous step used
      if (i_new < Nb)
        ric_stage(ring + (slot == 0 ? stages - 1 : slot - 1) * stage_floats, AB, H, G, Dd,
                  (size_t)lane * Nb + (Nb - 1 - i_new), n, nm, tid);
      __pipeline_commit();
    }
    const float* ab = ring + slot * stage_floats;
    const float* Hk = ab + n * nm;
    const float* gk = Hk + nm * nm;
    const float* dk = gk + nm;
    slot = (slot + 1 == stages) ? 0 : slot + 1;
    RIC_CLOCK(2);

    // Pab = P [A B], Pabu = Pab + rho [A B];  p~ = p + dfct * P d
    for (int e = tid; e < n * nm + n; e += RIC_THREADS) {
      if (e < n * nm) {
        const int r = e / nm, c = e - r * nm;
        const float acc = ric_dot(P + r * n, 1, ab + c, nm, n);
        Pab[e] = acc;
        if (state_reg) Pabu[e] = acc + rho * ab[e];
      } else {
        const int r = e - n * nm;
        pt[r] = use_defect ? p[r] + (dfct ? 1.f : 0.f) * ric_dot(P + r * n, 1, dk, 1, n) : p[r];
      }
    }
    __syncthreads();   // barrier 2
    RIC_CLOCK(3);

    // Hq = H + G (x-rows: A^T P [A B]; u-rows: B^T (P + rho I) [A B] under
    // state reg, else rho on Huu's diagonal);  gq = g + [A B]^T p~
    for (int e = tid; e < nm * nm + nm; e += RIC_THREADS) {
      if (e < nm * nm) {
        const int r = e / nm, c = e - r * nm;
        const float* W = (state_reg && r >= n) ? Pabu : Pab;
        float h = Hk[e] + ric_dot(ab + r, nm, W + c, nm, n);
        if (!state_reg && r >= n && r == c) h = h + rho;
        Hq[e] = h;
      } else {
        const int r = e - nm * nm;
        gq[r] = gk[r] + ric_dot(ab + r, nm, pt, 1, n);
      }
    }
    __syncthreads();   // barrier 3
    RIC_CLOCK(4);

    // sol = Huu^-1 [Hux | gu] by Cholesky (Huu + I at the terminal step) with
    // the PD test; failed pivots are clamped to 1 so the solution stays
    // finite (ops/linalg.py).  Lane c of the first warp: its own copy of the
    // factor in registers and right-hand side c.
    if (tid < n1) {
      const int c = tid;
      float a[RIC_MMAX][RIC_MMAX], inv[RIC_MMAX], z[RIC_MMAX], s[RIC_MMAX];
#pragma unroll
      for (int r = 0; r < RIC_MMAX; ++r) {
        z[r] = (r < m) ? ((c < n) ? Hq[(n + r) * nm + c] : gq[n + r]) : 0.f;
#pragma unroll
        for (int cc = 0; cc <= r; ++cc) a[r][cc] = (r < m) ? Hq[(n + r) * nm + n + cc] : 0.f;
      }
      int ok = 1;
#pragma unroll
      for (int j = 0; j < RIC_MMAX; ++j) {
        if (j < m) {
          float acc = a[j][j] + (term ? 1.f : 0.f);
#pragma unroll
          for (int kk = 0; kk < j; ++kk) acc = acc - a[j][kk] * a[j][kk];
          const bool pos = acc > 0.f;
          ok = ok && pos;
          const float ljj = sqrtf(pos ? acc : 1.f);
          a[j][j] = ljj;
          inv[j] = 1.f / ljj;
#pragma unroll
          for (int r = j + 1; r < RIC_MMAX; ++r) {
            if (r < m) {
              float a2 = a[r][j];
#pragma unroll
              for (int kk = 0; kk < j; ++kk) a2 = a2 - a[r][kk] * a[j][kk];
              a[r][j] = a2 * inv[j];
            }
          }
          // forward substitution, row j (z[j] holds the right-hand side)
          float b = z[j];
#pragma unroll
          for (int kk = 0; kk < j; ++kk) b = b - a[j][kk] * z[kk];
          z[j] = ric_div(b, ljj, inv[j]);
        }
      }
#pragma unroll
      for (int r = RIC_MMAX - 1; r >= 0; --r) {
        if (r < m) {
          float acc = z[r];
#pragma unroll
          for (int kk = r + 1; kk < RIC_MMAX; ++kk) {
            if (kk < m) acc = acc - a[kk][r] * s[kk];
          }
          s[r] = ric_div(acc, a[r][r], inv[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < RIC_MMAX; ++r) {
        if (r < m) {
          sol[r * n1 + c] = s[r];
          // the gains, at step index t (ascending k)
          if (c < n) K_out[(step * m + r) * n + c] = term ? 0.f : s[r];
          else du_out[step * m + r] = term ? 0.f : s[r];
        }
      }
      if (c == 0) *s_ok = ok;
    }
    RIC_CLOCK(5);
    __syncthreads();   // barrier 4
    RIC_CLOCK(6);

    // outputs and the carry for step k-1, one entry per thread (column n is
    // the gradient's):
    //   s1 = (sol^T [Hux | gu])[r][c]   (= K^T Hux, K^T gu: summed once)
    //   s2 = (Hxu sol)[r][c]
    //   P' = ((Hxx + s1) - s2) - s1,  p' likewise from gx  (state reg)
    //   P' = Hxx - s2                                      (otherwise)
    // then B sol for A - B K and B du
    for (int e = tid; e < 2 * n * n1; e += RIC_THREADS) {
      if (e < n * n1) {
        const int r = e / n1, c = e - r * n1;
        const float s2 = ric_dot(Hq + r * nm + n, 1, sol + c, n1, m);
        const float h0 = (c < n) ? Hq[r * nm + c] : gq[r];
        float pn = h0 - s2;
        if (state_reg) {   // column c of [Hux | gu]
          const float s1 = ric_dot(sol + r, n1, c < n ? Hq + n * nm + c : gq + n, c < n ? nm : 1, m);
          pn = ((h0 + s1) - s2) - s1;
        }
        if (c < n) {
          const float v = term ? P[r * n + c] : pn;
          P[r * n + c] = v;
          P_out[step * n * n + r * n + c] = v;
        } else {
          const float v = term ? p[r] : pn;
          p[r] = v;
          p_out[step * n + r] = v;
        }
      } else {
        const int f = e - n * n1;
        const int r = f / n1, c = f - r * n1;
        const float bs = ric_dot(ab + r * nm + n, 1, sol + c, n1, m);
        if (c < n) ApBK_out[step * n * n + r * n + c] = term ? 0.f : ab[r * nm + c] - bs;
        else Bdu_out[step * n + r] = term ? 0.f : bs;
      }
    }
    // dJ terms du . gu and du . (Huu du), Huu without the terminal + I: one
    // control row per lane of the last warp, gathered in row order
    if (tid >= tally) {
      const int r = tid - tally;
      float g_t = 0.f, h_t = 0.f;
      if (r < m) {
        const float du_r = sol[r * n1 + n];
        g_t = du_r * gq[n + r];
        h_t = du_r * ric_dot(Hq + (n + r) * nm + n, 1, sol + n, n1, m);
      }
      float dj0 = 0.f, dj1 = 0.f;
#pragma unroll
      for (int q = 0; q < RIC_MMAX; ++q) {
        const float g_q = __shfl_sync(0xffffffffu, g_t, q);
        const float h_q = __shfl_sync(0xffffffffu, h_t, q);
        if (q < m) {
          dj0 = dj0 + g_q;
          dj1 = dj1 + h_q;
        }
      }
      if (tid == tally) {
        if (!term) {
          dj0_acc = dj0_acc + dj0;
          dj1_acc = dj1_acc + dj1;
        }
        fail_acc = fail_acc || (!*s_ok && !term);
      }
    }
    RIC_CLOCK(7);
  }

  if (tid == tally) {
    dj_lane[lane * 2 + 0] = dj0_acc;
    dj_lane[lane * 2 + 1] = dj1_acc;
    fail_lane[lane] = fail_acc;
    __threadfence();
    // the last of the scenario's blocks to arrive sums its lanes in lane order
    if (atomicAdd(lanes_done + scen, 1u) == static_cast<unsigned int>(lanes - 1)) {
      __threadfence();
      const volatile float* vd = dj_lane + (size_t)scen * lanes * 2;
      const volatile int* vf = fail_lane + (size_t)scen * lanes;
      float s0 = 0.f, s1 = 0.f;
      int f = 0;
      for (int l = 0; l < lanes; ++l) {
        s0 = s0 + vd[2 * l];
        s1 = s1 + vd[2 * l + 1];
        f = f | vf[l];
      }
      dj_total[2 * scen] = s0;
      dj_total[2 * scen + 1] = s1;
      fail_total[scen] = f ? 1 : 0;
    }
  }
}

// S scenarios of Mb lanes, scenario-major: seedP (S, Mb, n, n), seedp (S, Mb, n),
// rho (one float, rho_stride 0, or one per lane (S, Mb), rho_stride 1), AB
// (S, Mb, Nb, n, n+m), H (S, Mb, Nb, n+m, n+m), g (S, Mb, Nb, n+m), d (S, Mb, Nb,
// n), and the step indices k (Mb, Nb) int64, the same for every scenario.
// Outputs in the (S, Mb, Nb, ...) layout, per-lane dJ (S, Mb, 2) and fail
// (S, Mb) int32, and their reductions over each scenario's lanes dj_total
// (S, 2) and fail_total (S) bytes (0 or 1); lanes_done (S) is this call's
// scratch counters, zeroed here.
// clocks: null, or (Nb, RIC_CLOCK_SLOTS) int64 for a RIC_PHASE_CLOCKS build.
extern "C" int pddp_riccati(const float* seedP, const float* seedp, const float* rho,
                            int rho_stride, const float* AB, const float* H, const float* g,
                            const float* d, const long long* k, float* P_out, float* p_out,
                            float* K_out, float* du_out, float* ApBK_out, float* Bdu_out,
                            float* dj_lane, int* fail_lane, float* dj_total,
                            unsigned char* fail_total, unsigned int* lanes_done, int S, int Mb,
                            int Nb, int n, int m, int nf, int n_blocks_f, int state_reg,
                            int use_defect, long long* clocks, void* stream) {
  if (n > RIC_NMAX || m > RIC_MMAX || n <= 0 || m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (S <= 0 || Mb <= 0 || Nb <= 0) return 0;
  if (static_cast<long long>(S) * Mb > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);

  static int optin_bytes[64];            // per device, 0 until asked
  static unsigned char configured[64];   // bit 0: generic body, bit 1: (14, 7)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (optin_bytes[dev] == 0) {
    err = cudaDeviceGetAttribute(&optin_bytes[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  const int nm = n + m, n1 = n + 1;
  const int fixed_floats = n * n + 2 * n + 2 * n * nm + nm * nm + nm + m * n1 + 1;
  const int stage_floats = n * nm + nm * nm + nm + n;
  const int cap = (optin_bytes[dev] / 4 - fixed_floats) / stage_floats;
  if (cap < 2) return static_cast<int>(cudaErrorInvalidValue);
  const int stages = Nb < cap ? Nb : cap;
  const size_t bytes = sizeof(float) * (static_cast<size_t>(fixed_floats) +
                                        static_cast<size_t>(stages) * stage_floats);

  const bool kuka = (n == 14 && m == 7);
  decltype(&riccati_kernel<0, 0>) kern = kuka ? riccati_kernel<14, 7> : riccati_kernel<0, 0>;
  const unsigned char bit = kuka ? 2 : 1;
  if (bytes > 48 * 1024 && !(configured[dev] & bit)) {
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kern),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin_bytes[dev]);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] |= bit;
  }
  err = cudaMemsetAsync(lanes_done, 0, sizeof(unsigned int) * S,
                        static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<S * Mb, RIC_THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      seedP, seedp, rho, rho_stride, AB, H, g, d, k, P_out, p_out, K_out, du_out, ApBK_out,
      Bdu_out, dj_lane, fail_lane, dj_total, fail_total, lanes_done, Mb, Nb, n, m, nf,
      n_blocks_f, state_reg, use_defect, stages, clocks);
  return static_cast<int>(cudaGetLastError());
}
