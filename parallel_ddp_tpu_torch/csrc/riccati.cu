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
//
// Design: one thread block per backward-block lane, mirroring the
// reference's backPassKern<<<M_BLOCKS_B, (8, 7)>>>.  P and p live in shared
// memory across the Nb serial steps; each step's AB, H, g and d are loaded
// into shared memory, and the block's threads share out the matrix entries of
// each phase, with __syncthreads between phases.  The 7x7 Cholesky runs on
// one thread; its 15 right-hand sides are solved by one thread each.
// rho is per lane.  15 KB of static shared memory, sized for n <= 16 and
// m <= 8 (the wrapper refuses larger plants).
//
// What bounds it on the H100: at the main path there are M = 4 lanes (4
// blocks of 128 threads on 4 of the 132 SMs) and Nb = 16 dependent steps of
// ~10k flops each.  It is latency-bound: the time is the chain of ~8
// barrier-separated phases per step.  Keeping P, p and every temporary in
// shared memory keeps that chain off device memory except for the step's own
// inputs and outputs.

#include <cuda_runtime.h>

#define RIC_NMAX 16
#define RIC_MMAX 8
#define RIC_NMMAX (RIC_NMAX + RIC_MMAX)
#define RIC_THREADS 128

__global__ void __launch_bounds__(RIC_THREADS)
riccati_kernel(const float* __restrict__ seedP, const float* __restrict__ seedp,
               const float* __restrict__ rho_l, const float* __restrict__ AB,
               const float* __restrict__ H, const float* __restrict__ G,
               const float* __restrict__ Dd, const int* __restrict__ kidx,
               float* __restrict__ P_out, float* __restrict__ p_out, float* __restrict__ K_out,
               float* __restrict__ du_out, float* __restrict__ ApBK_out,
               float* __restrict__ Bdu_out, float* __restrict__ dj_out, int* __restrict__ fail_out,
               int Nb, int n, int m, int nf, int n_blocks_f, int state_reg, int use_defect) {
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int nm = n + m;
  const int n1 = n + 1;

  __shared__ float P[RIC_NMAX * RIC_NMAX], p[RIC_NMAX];
  __shared__ float ab[RIC_NMAX * RIC_NMMAX], Hk[RIC_NMMAX * RIC_NMMAX], gk[RIC_NMMAX], dk[RIC_NMAX];
  __shared__ float Pab[RIC_NMAX * RIC_NMMAX], Hq[RIC_NMMAX * RIC_NMMAX], gq[RIC_NMMAX], pt[RIC_NMAX];
  __shared__ float L[RIC_MMAX * RIC_MMAX], sol[RIC_MMAX * (RIC_NMAX + 1)];
  __shared__ float StZ[(RIC_NMAX + 1) * (RIC_NMAX + 1)], HxuS[RIC_NMAX * (RIC_NMAX + 1)];
  __shared__ float KtHux[RIC_NMAX * (RIC_NMAX + 1)], BS[RIC_NMAX * (RIC_NMAX + 1)];
  __shared__ int s_ok;
  __shared__ float s_dj0, s_dj1;

  const float rho = rho_l[lane];
  for (int e = tid; e < n * n; e += RIC_THREADS) P[e] = seedP[(size_t)lane * n * n + e];
  for (int e = tid; e < n; e += RIC_THREADS) p[e] = seedp[(size_t)lane * n + e];
  float dj0_acc = 0.f, dj1_acc = 0.f;
  int fail_acc = 0;

  for (int t = Nb - 1; t >= 0; --t) {
    const size_t step = (size_t)lane * Nb + t;
    const int k = kidx[step];
    const bool term = (k == nf);
    const bool dfct = use_defect && ((k + 1) % n_blocks_f == 0) && (k < nf);

    __syncthreads();  // the previous step's readers of ab/Hk/Hq are done
    for (int e = tid; e < n * nm; e += RIC_THREADS) ab[e] = AB[step * n * nm + e];
    for (int e = tid; e < nm * nm; e += RIC_THREADS) Hk[e] = H[step * nm * nm + e];
    for (int e = tid; e < nm; e += RIC_THREADS) gk[e] = G[step * nm + e];
    for (int e = tid; e < n; e += RIC_THREADS) dk[e] = Dd[step * n + e];
    __syncthreads();

    // Pab = P [A B];  p~ = p + dfct * P d
    for (int e = tid; e < n * nm + n; e += RIC_THREADS) {
      if (e < n * nm) {
        const int i = e / nm, j = e - (e / nm) * nm;
        float acc = P[i * n] * ab[j];
        for (int l = 1; l < n; ++l) acc = acc + P[i * n + l] * ab[l * nm + j];
        Pab[e] = acc;
      } else {
        const int i = e - n * nm;
        if (use_defect) {
          float acc = P[i * n] * dk[0];
          for (int l = 1; l < n; ++l) acc = acc + P[i * n + l] * dk[l];
          pt[i] = p[i] + (dfct ? 1.f : 0.f) * acc;
        } else {
          pt[i] = p[i];
        }
      }
    }
    __syncthreads();

    // Hq = H + G (x-rows: A^T P [A B]; u-rows: B^T (P + rho I) [A B] under state reg)
    for (int e = tid; e < nm * nm + nm; e += RIC_THREADS) {
      if (e < nm * nm) {
        const int i = e / nm, j = e - (e / nm) * nm;
        float acc;
        if (state_reg && i >= n) {
          acc = ab[i] * (Pab[j] + rho * ab[j]);
          for (int l = 1; l < n; ++l) acc = acc + ab[l * nm + i] * (Pab[l * nm + j] + rho * ab[l * nm + j]);
        } else {
          acc = ab[i] * Pab[j];
          for (int l = 1; l < n; ++l) acc = acc + ab[l * nm + i] * Pab[l * nm + j];
        }
        float h = Hk[e] + acc;
        if (!state_reg && i >= n && i == j) h = h + rho;
        Hq[e] = h;
      } else {
        const int i = e - nm * nm;
        float acc = ab[i] * pt[0];
        for (int l = 1; l < n; ++l) acc = acc + ab[l * nm + i] * pt[l];
        gq[i] = gk[i] + acc;
      }
    }
    __syncthreads();

    // Cholesky of Huu (+ I at the terminal step) with the PD test; failed
    // pivots are clamped to 1 so the solution stays finite (ops/linalg.py)
    if (tid == 0) {
      int ok = 1;
      for (int j = 0; j < m; ++j) {
        float acc = Hq[(n + j) * nm + n + j] + (term ? 1.f : 0.f);
        for (int kk = 0; kk < j; ++kk) acc = acc - L[j * m + kk] * L[j * m + kk];
        const bool pos = acc > 0.f;
        ok = ok && pos;
        L[j * m + j] = sqrtf(pos ? acc : 1.f);
        const float inv = 1.f / L[j * m + j];
        for (int i = j + 1; i < m; ++i) {
          float a2 = Hq[(n + i) * nm + n + j];
          for (int kk = 0; kk < j; ++kk) a2 = a2 - L[i * m + kk] * L[j * m + kk];
          L[i * m + j] = a2 * inv;
        }
      }
      s_ok = ok;
    }
    __syncthreads();

    // sol = Huu^-1 [Hux | gu], one right-hand side per thread
    for (int c = tid; c < n1; c += RIC_THREADS) {
      float z[RIC_MMAX];
      for (int i = 0; i < m; ++i) {
        float acc = (c < n) ? Hq[(n + i) * nm + c] : gq[n + i];
        for (int kk = 0; kk < i; ++kk) acc = acc - L[i * m + kk] * z[kk];
        z[i] = acc / L[i * m + i];
      }
      for (int i = m - 1; i >= 0; --i) {
        float acc = z[i];
        for (int kk = i + 1; kk < m; ++kk) acc = acc - L[kk * m + i] * sol[kk * n1 + c];
        sol[i * n1 + c] = acc / L[i * m + i];
      }
    }
    __syncthreads();

    // products of the solution: StZ = sol^T [Hux | gu], HxuS = Hxu sol,
    // KtHux = K^T Hux and Ktgu = K^T gu (state reg only), BS = B sol
    const int nStZ = state_reg ? n1 * n1 : 0;
    const int nHxuS = n * n1;
    const int nKt = state_reg ? n * n1 : 0;
    const int nBS = n * n1;
    for (int e = tid; e < nStZ + nHxuS + nKt + nBS + 1; e += RIC_THREADS) {
      if (e < nStZ) {
        const int i = e / n1, j = e - (e / n1) * n1;
        float acc = sol[i] * ((j < n) ? Hq[n * nm + j] : gq[n]);
        for (int r = 1; r < m; ++r)
          acc = acc + sol[r * n1 + i] * ((j < n) ? Hq[(n + r) * nm + j] : gq[n + r]);
        StZ[e] = acc;
      } else if (e < nStZ + nHxuS) {
        const int f = e - nStZ;
        const int i = f / n1, j = f - (f / n1) * n1;
        float acc = Hq[i * nm + n] * sol[j];
        for (int r = 1; r < m; ++r) acc = acc + Hq[i * nm + n + r] * sol[r * n1 + j];
        HxuS[f] = acc;
      } else if (e < nStZ + nHxuS + nKt) {
        // K^T [Hux | gu]: the same sums as StZ's first n rows, computed on
        // their own as the reference does (sol[:, :n].T @ Hux, ... @ gu)
        const int f = e - nStZ - nHxuS;
        const int i = f / n1, j = f - (f / n1) * n1;
        float acc = sol[i] * ((j < n) ? Hq[n * nm + j] : gq[n]);
        for (int r = 1; r < m; ++r)
          acc = acc + sol[r * n1 + i] * ((j < n) ? Hq[(n + r) * nm + j] : gq[n + r]);
        KtHux[f] = acc;
      } else if (e < nStZ + nHxuS + nKt + nBS) {
        const int f = e - nStZ - nHxuS - nKt;
        const int i = f / n1, j = f - (f / n1) * n1;
        float acc = ab[i * nm + n] * sol[j];
        for (int r = 1; r < m; ++r) acc = acc + ab[i * nm + n + r] * sol[r * n1 + j];
        BS[f] = acc;
      } else {
        // dJ terms: du . gu and du . (Huu du), Huu without the terminal + I
        float dj0 = 0.f, dj1 = 0.f;
        for (int i = 0; i < m; ++i) {
          float hd = Hq[(n + i) * nm + n] * sol[n];
          for (int j = 1; j < m; ++j) hd = hd + Hq[(n + i) * nm + n + j] * sol[j * n1 + n];
          const float du_i = sol[i * n1 + n];
          dj0 = dj0 + du_i * gq[n + i];
          dj1 = dj1 + du_i * hd;
        }
        s_dj0 = dj0;
        s_dj1 = dj1;
      }
    }
    __syncthreads();

    // outputs at step index t (ascending k) and the carry for step k-1
    for (int e = tid; e < n * n + n + m * n + m; e += RIC_THREADS) {
      if (e < n * n) {
        const int i = e / n, j = e - (e / n) * n;
        const float hxx = Hq[i * nm + j];
        float pn = state_reg ? ((hxx + StZ[i * n1 + j]) - HxuS[i * n1 + j]) - KtHux[i * n1 + j]
                             : hxx - HxuS[i * n1 + j];
        const float v = term ? P[e] : pn;
        P[e] = v;
        P_out[step * n * n + e] = v;
        ApBK_out[step * n * n + e] = term ? 0.f : ab[i * nm + j] - BS[i * n1 + j];
      } else if (e < n * n + n) {
        const int i = e - n * n;
        const float gx = gq[i];
        float pn = state_reg ? ((gx + StZ[i * n1 + n]) - HxuS[i * n1 + n]) - KtHux[i * n1 + n]
                             : gx - HxuS[i * n1 + n];
        const float v = term ? p[i] : pn;
        p[i] = v;
        p_out[step * n + i] = v;
        Bdu_out[step * n + i] = term ? 0.f : BS[i * n1 + n];
      } else if (e < n * n + n + m * n) {
        const int f = e - n * n - n;
        const int i = f / n, j = f - (f / n) * n;
        K_out[step * m * n + f] = term ? 0.f : sol[i * n1 + j];
      } else {
        const int i = e - n * n - n - m * n;
        du_out[step * m + i] = term ? 0.f : sol[i * n1 + n];
      }
    }
    if (tid == 0) {
      if (!term) {
        dj0_acc = dj0_acc + s_dj0;
        dj1_acc = dj1_acc + s_dj1;
      }
      fail_acc = fail_acc || (!s_ok && !term);
    }
  }
  if (tid == 0) {
    dj_out[lane * 2 + 0] = dj0_acc;
    dj_out[lane * 2 + 1] = dj1_acc;
    fail_out[lane] = fail_acc;
  }
}

// Lane-major inputs: seedP (Mb, n, n), seedp (Mb, n), rho (Mb), AB (Mb, Nb, n, n+m),
// H (Mb, Nb, n+m, n+m), g (Mb, Nb, n+m), d (Mb, Nb, n), k (Mb, Nb) int32.
// Outputs in the same (Mb, Nb, ...) layout, plus dJ (Mb, 2) and fail (Mb) int32.
extern "C" int pddp_riccati(const float* seedP, const float* seedp, const float* rho,
                            const float* AB, const float* H, const float* g, const float* d,
                            const int* k, float* P_out, float* p_out, float* K_out,
                            float* du_out, float* ApBK_out, float* Bdu_out, float* dj_out,
                            int* fail_out, int Mb, int Nb, int n, int m, int nf, int n_blocks_f,
                            int state_reg, int use_defect, void* stream) {
  if (n > RIC_NMAX || m > RIC_MMAX || n <= 0 || m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (Mb <= 0 || Nb <= 0) return 0;
  riccati_kernel<<<Mb, RIC_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      seedP, seedp, rho, AB, H, g, d, k, P_out, p_out, K_out, du_out, ApBK_out, Bdu_out, dj_out,
      fail_out, Nb, n, m, nf, n_blocks_f, state_reg, use_defect);
  return static_cast<int>(cudaGetLastError());
}
