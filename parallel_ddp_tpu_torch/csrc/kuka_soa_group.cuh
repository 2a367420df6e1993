// Kuka iiwa-14 forward dynamics qdd = M^{-1}(tau - C) by a GROUP of threads
// per evaluation: the formulas of kuka_soa.cuh::kuka_qdd, split into roles
// that run side by side.
//
// The group of one evaluation is KG_WARPS threads, ONE IN EACH WARP of a
// block of KG_WARPS warps: lane l of every warp works on evaluation l.  So
// the 32 lanes of a warp run the same role on 32 different evaluations (no
// divergence: the lanes of one warp run in lockstep, and different work on
// the lanes of one warp would be issued one piece after the other), and the
// roles of one evaluation run in different warps, which issue independently.
// The members of a group exchange through a column of shared memory
// (KG_FIELDS values, field f of lane l at ws[f * 32 + l]: conflict-free).
//
// Three stages, a block barrier between them:
//
//   trig    warps 0..6: cos/sin of joint w, computed once an evaluation.
//   sweeps  warps 0, 3, 4, 6, 7, 8: the RNEA.  The velocity/acceleration
//             sweep to link L is cheap and each of these warps repeats it;
//             the link's bias force f = I a + v x* (I v) (two 6x6 products,
//             the bulk of the RNEA) is what is spread: link 6 by warp 0,
//             links 5, 4, 3, 2 by warps 3, 4, 6, 8, links 0 and 1 by warp 7.
//             Once all have arrived at a named barrier, warp 0 runs the
//             backward sweep to the bias torques.
//           warp 1: the CRBA's composite inertias, leaf to root, in ONE
//             warp: a hand-over between warps costs a level more (shared
//             memory round trip, barrier or counter) than the 3x3 products
//             it would spread (measured: two, three and four warps a level
//             were all slower).  It keeps every level's A[:,2] and B[2,:]
//             and arrives at that level's named barrier.  It is the stage's
//             longest role, so warp 5, which would share its instruction
//             scheduler (warps w, w + 4, w + 8 do), stays idle: a lone busy
//             warp takes ~0.7 of a scheduler's issue slots.
//           warps 2 and 7: the mass-matrix columns' walks to the root,
//             column i as soon as its level's barrier completes (warp 2:
//             columns 6, 3, 2; warp 7, after its links: 5, 4, 1), so the
//             walks end a step or two after the composites.
//   solve   warp 0: the unrolled Cholesky (kg_factor: 7 square roots and 7
//             reciprocals) and the two substitutions (kg_subs: 14
//             divisions), ~70 cycles each IEEE operation, on one dependent
//             chain.
//
// The roles take the column's trig from fields tb .. tb + 13 (KG_CQ by
// default), so a caller can keep two steps' trig apart; the simulation chain
// (kuka_chain_group.cuh) does, and runs the factor of the next step beside
// this step's RNEA.  rollout.cu, rbd_jac.cu and qdd.cu run the stages below.
//
// Split by output element, never a sum: every scalar is computed by one
// thread with the expression and the order of kuka_soa.cuh (a role repeats
// what it needs of another's), so the two cores differ at most by where
// nvcc contracts a multiply-add.  On the host (the emulation that checks
// this header against kuka_soa.cuh with no contraction, one host thread a
// role) they agree bit for bit.
#pragma once

#include "kuka_soa.cuh"

#define KG_WARPS 9
#define KG_LANES 32
#define KG_THREADS (KG_WARPS * KG_LANES)

// fields of an evaluation's column
#define KG_X 0                      // in: x = [q; qd] (14)
#define KG_TAU (KG_X + 2 * KUKA_NJ) // in: tau (7)
#define KG_CQ (KG_TAU + KUKA_NJ)    // cos q (7)
#define KG_SQ (KG_CQ + KUKA_NJ)     // sin q (7)
#define KG_FL (KG_SQ + KUKA_NJ)     // link bias forces (7, 6)
#define KG_CB (KG_FL + 6 * KUKA_NJ) // bias torques (7)
#define KG_FN (KG_CB + KUKA_NJ)     // A_i[:, 2] of every level (7, 3)
#define KG_FF (KG_FN + 3 * KUKA_NJ) // B_i[2, :] of every level (7, 3)
#define KG_M (KG_FF + 3 * KUKA_NJ)  // M[i][j], j < i, at i(i-1)/2 + j (21)
#define KG_QDD (KG_M + 21)          // out: qdd (7)
#define KG_FIELDS (KG_QDD + KUKA_NJ)

// named barriers (0 is the block's)
#define KG_BAR_LINKS 1              // the six RNEA warps: every link force is written
#define KG_BAR_LEVEL 2              // + i: level i = 1..5 of the composites is written
#define KG_RNEA_WARPS 6

#ifndef KG_HOST_EMULATION
__device__ __forceinline__ void kg_sync_block() { __syncthreads(); }
// whole warps only; `threads` counts all that arrive at or wait on the barrier
__device__ __forceinline__ void kg_bar_arrive(int id, int threads) {
  __threadfence_block();
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void kg_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
#endif

// Built with -DKG_PHASE_CLOCKS (scripts/torch_dynamics_phases.py only), lane 0
// of each warp of block 0 records clock64() where a role finishes a piece.
#ifdef KG_PHASE_CLOCKS
#define KG_N_MARKS 32
__device__ long long kg_marks[KG_N_MARKS];
#define KG_MARK(k) \
  do { if ((threadIdx.x & 31) == 0 && blockIdx.x == 0) kg_marks[k] = clock64(); } while (0)
#else
#define KG_MARK(k)
#endif

// One evaluation's column of the workspace.
template <typename T>
struct KgCol {
  T* p;
  __device__ __forceinline__ T& operator[](int f) const { return p[f * KG_LANES]; }
};

// The trig of a column: cos q_i at field tb + i, sin q_i at tb + KUKA_NJ + i;
// tb = KG_CQ but where a caller keeps more than one set (kuka_chain_group.cuh).
template <typename T>
__device__ __forceinline__ void kg_rot(const float* __restrict__ cc, KgCol<T> col, int i,
                                       T r[3][3], int tb = KG_CQ) {
  local_rot(cc, i, T(col[tb + i]), T(col[tb + KUKA_NJ + i]), r);
}

// ---------------------------------------------------------------- roles --

// cos/sin of joint w
template <typename T>
__device__ __forceinline__ void kg_trig(KgCol<T> col, int w) {
  if (w < KUKA_NJ) {
    const T q = col[KG_X + w];
    col[KG_CQ + w] = s_cos(q);
    col[KG_SQ + w] = s_sin(q);
  }
}

// RNEA forward sweep (qdd = 0, gravity as base acceleration) to link L, then
// that link's bias force f = I a + v x* (I v)
template <typename T>
__device__ void kg_link(const float* __restrict__ cc, KgCol<T> col, int L, int tb = KG_CQ) {
  T w[3] = {T(0.f), T(0.f), T(0.f)};
  T v[3] = {T(0.f), T(0.f), T(0.f)};
  T dw[3] = {T(0.f), T(0.f), T(0.f)};
  T dv[3] = {T(0.f), T(0.f), T(cc[KC_G])};
#pragma unroll 1
  for (int i = 0; i <= L; ++i) {
    T r[3][3];
    kg_rot(cc, col, i, r, tb);
    const float* p = cc + KC_P + 3 * i;
    typedef typename KcAs<T>::factor C;
    C pv[3] = {C(p[0]), C(p[1]), C(p[2])};
    T t[3];
    v_cross(w, pv, t);
    t[0] = v[0] + t[0]; t[1] = v[1] + t[1]; t[2] = v[2] + t[2];
    mT_vec(r, t, v);
    mT_vec(r, w, w);
    v_cross(dw, pv, t);
    t[0] = dv[0] + t[0]; t[1] = dv[1] + t[1]; t[2] = dv[2] + t[2];
    mT_vec(r, t, dv);
    mT_vec(r, dw, dw);
    T s = col[KG_X + KUKA_NJ + i];
    dw[0] = dw[0] + w[1] * s; dw[1] = dw[1] + (-w[0]) * s;
    dv[0] = dv[0] + v[1] * s; dv[1] = dv[1] + (-v[0]) * s;
    w[2] = w[2] + s;
  }
  const float* ii = cc + KC_I + 36 * L;
  T mv[6] = {w[0], w[1], w[2], v[0], v[1], v[2]};
  T ma[6] = {dw[0], dw[1], dw[2], dv[0], dv[1], dv[2]};
  T iv[6], fa[6];
  i_mul6(ii, mv, iv);
  i_mul6(ii, ma, fa);
  T c1[3], c2[3], c3[3];
  v_cross(w, iv, c1);       // w x (I v)[:3]
  v_cross(v, iv + 3, c2);   // v x (I v)[3:]
  v_cross(w, iv + 3, c3);   // w x (I v)[3:]
  col[KG_FL + 6 * L + 0] = fa[0] + (c1[0] + c2[0]);
  col[KG_FL + 6 * L + 1] = fa[1] + (c1[1] + c2[1]);
  col[KG_FL + 6 * L + 2] = fa[2] + (c1[2] + c2[2]);
  col[KG_FL + 6 * L + 3] = fa[3] + c3[0];
  col[KG_FL + 6 * L + 4] = fa[4] + c3[1];
  col[KG_FL + 6 * L + 5] = fa[5] + c3[2];
  KG_MARK(L);
}

// RNEA backward sweep over the link forces: bias torques
template <typename T>
__device__ void kg_backward(const float* __restrict__ cc, KgCol<T> col, int tb = KG_CQ) {
  T n_acc[3] = {T(0.f), T(0.f), T(0.f)};
  T f_acc[3] = {T(0.f), T(0.f), T(0.f)};
#pragma unroll 1
  for (int i = KUKA_NJ - 1; i >= 0; --i) {
    T nt[3], ft[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      nt[k] = col[KG_FL + 6 * i + k] + n_acc[k];
      ft[k] = col[KG_FL + 6 * i + 3 + k] + f_acc[k];
    }
    col[KG_CB + i] = nt[2];
    T r[3][3];
    kg_rot(cc, col, i, r, tb);
    force_to_parent(r, cc + KC_P + 3 * i, nt, ft);
#pragma unroll
    for (int k = 0; k < 3; ++k) { n_acc[k] = nt[k]; f_acc[k] = ft[k]; }
  }
  KG_MARK(8);
}

// CRBA: the composite inertias ic = [[A, B], [B^T, D]], leaf to root; of
// every level it keeps F = Ic_i [e3; 0] = [A[:,2]; B[2,:]], where column
// i's walk starts, and arrives at the level's barrier
template <typename T>
__device__ void kg_composites(const float* __restrict__ cc, KgCol<T> col, int tb = KG_CQ) {
  const int n = KUKA_NJ;
  T A[3][3], Bm[3][3], D[3][3];
  {
    const float* ii = cc + KC_I + 36 * (n - 1);
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        A[r][c] = T(ii[6 * r + c]);
        Bm[r][c] = T(ii[6 * r + 3 + c]);
        D[r][c] = T(ii[6 * (3 + r) + 3 + c]);
      }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    col[KG_FN + 3 * (n - 1) + k] = A[k][2];
    col[KG_FF + 3 * (n - 1) + k] = Bm[2][k];
  }
#pragma unroll 1
  for (int i = n - 1; i >= 1; --i) {
    // ic[i-1] = I[i-1] + X^T ic[i] X with X = [[R, 0], [S, R]], R = r^T, S = -r^T p^
    T r[3][3], rt[3][3], sk[3][3], s_m[3][3];
    kg_rot(cc, col, i, r, tb);
    m_T(r, rt);
    const float* p = cc + KC_P + 3 * i;
    sk[0][0] = T(0.f);  sk[0][1] = T(-p[2]); sk[0][2] = T(p[1]);
    sk[1][0] = T(p[2]); sk[1][1] = T(0.f);   sk[1][2] = T(-p[0]);
    sk[2][0] = T(-p[1]); sk[2][1] = T(p[0]); sk[2][2] = T(0.f);
    m_mul(rt, sk, s_m);
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) s_m[a][b] = -s_m[a][b];
    T rta[3][3], rtb[3][3], rtd[3][3], smT[3][3], std_[3][3], e_m[3][3];
    m_mul(r, A, rta);     // R^T A  (R^T = r)
    m_mul(r, Bm, rtb);    // R^T B
    m_mul(r, D, rtd);     // R^T D
    m_T(s_m, smT);
    m_mul(smT, D, std_);  // S^T D
    m_mul(rtb, s_m, e_m); // R^T B S
    T tl[3][3], sds[3][3], tr[3][3], sdr[3][3], br[3][3];
    m_mul(rta, rt, tl);
    m_mul(std_, s_m, sds);
    m_mul(rtb, rt, tr);
    m_mul(std_, rt, sdr);
    m_mul(rtd, rt, br);
    const float* ii = cc + KC_I + 36 * (i - 1);
    typedef typename KcAs<T>::term Term;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        A[a][b] = Term(ii[6 * a + b]) + (((tl[a][b] + e_m[a][b]) + e_m[b][a]) + sds[a][b]);
        Bm[a][b] = Term(ii[6 * a + 3 + b]) + (tr[a][b] + sdr[a][b]);
        D[a][b] = Term(ii[6 * (3 + a) + 3 + b]) + br[a][b];
      }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      col[KG_FN + 3 * (i - 1) + k] = A[k][2];
      col[KG_FF + 3 * (i - 1) + k] = Bm[2][k];
    }
    if (i > 1) kg_bar_arrive(KG_BAR_LEVEL + i - 1, 2 * KG_LANES);
    KG_MARK(10 + i - 1);
  }
}

// mass-matrix column i below the diagonal: its level's F walked to the root,
// once the level is there (the leaf's F is the link's own inertia: constants)
template <typename T>
__device__ void kg_walk(const float* __restrict__ cc, KgCol<T> col, int i, int tb = KG_CQ) {
  T nf[3], ff[3];
  if (i == KUKA_NJ - 1) {
    const float* ii = cc + KC_I + 36 * i;
#pragma unroll
    for (int k = 0; k < 3; ++k) { nf[k] = T(ii[6 * k + 2]); ff[k] = T(ii[6 * 2 + 3 + k]); }
  } else {
    kg_bar_sync(KG_BAR_LEVEL + i, 2 * KG_LANES);
#pragma unroll
    for (int k = 0; k < 3; ++k) { nf[k] = col[KG_FN + 3 * i + k]; ff[k] = col[KG_FF + 3 * i + k]; }
  }
#pragma unroll 1
  for (int j = i - 1; j >= 0; --j) {
    T r[3][3];
    kg_rot(cc, col, j + 1, r, tb);
    force_to_parent(r, cc + KC_P + 3 * (j + 1), nf, ff);
    col[KG_M + i * (i - 1) / 2 + j] = nf[2];
  }
  KG_MARK(20 + i);
}

// The unrolled Cholesky of kuka_soa.cuh in two parts: the factor L of M (the
// diagonal from the composites' A[2][2], the rest from the walks), and the
// two substitutions qdd = L^-T L^-1 (tau - C).  kg_solve runs both in one
// thread; the Euler chain (kuka_chain_group.cuh) runs the factor of the next
// step beside this one's RNEA and hands L on through the column.
template <typename T>
__device__ __forceinline__ void kg_factor(KgCol<T> col, T L[KUKA_NJ][KUKA_NJ]) {
  const int n = KUKA_NJ;
  T M[KUKA_NJ][KUKA_NJ];
#pragma unroll
  for (int i = 0; i < n; ++i) {
    M[i][i] = col[KG_FN + 3 * i + 2];
#pragma unroll
    for (int j = 0; j < i; ++j) M[i][j] = col[KG_M + i * (i - 1) / 2 + j];
  }
#pragma unroll
  for (int j = 0; j < n; ++j) {
    T acc = M[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) acc = acc - L[j][k] * L[j][k];
    L[j][j] = s_sqrt(acc);
    T inv = 1.0f / L[j][j];
#pragma unroll
    for (int i = j + 1; i < n; ++i) {
      T a2 = M[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) a2 = a2 - L[i][k] * L[j][k];
      L[i][j] = a2 * inv;
    }
  }
}

// qdd = L^-T L^-1 (tau - C) into KG_QDD, with L lower triangular (the upper
// part is not read)
template <typename T>
__device__ __forceinline__ void kg_subs(KgCol<T> col, const T L[KUKA_NJ][KUKA_NJ]) {
  const int n = KUKA_NJ;
  T z[KUKA_NJ], qdd[KUKA_NJ];
#pragma unroll
  for (int i = 0; i < n; ++i) {
    T acc = T(col[KG_TAU + i]) - T(col[KG_CB + i]);
#pragma unroll
    for (int k = 0; k < i; ++k) acc = acc - L[i][k] * z[k];
    z[i] = acc / L[i][i];
  }
#pragma unroll
  for (int i = n - 1; i >= 0; --i) {
    T acc = z[i];
#pragma unroll
    for (int k = i + 1; k < n; ++k) acc = acc - L[k][i] * qdd[k];
    qdd[i] = acc / L[i][i];
  }
#pragma unroll
  for (int i = 0; i < n; ++i) col[KG_QDD + i] = qdd[i];
}

// qdd = M^{-1} (tau - C): both parts in one thread
template <typename T>
__device__ void kg_solve(KgCol<T> col) {
  T L[KUKA_NJ][KUKA_NJ];
  kg_factor(col, L);
  kg_subs(col, L);
}

// --------------------------------------------------------------- stages --
// Each is called by every thread of the block with its warp index w; a block
// barrier separates one from the next.

template <typename T>
__device__ __forceinline__ void kg_stage_sweeps(const float* __restrict__ cc, KgCol<T> col,
                                                int w) {
  if (w == 1) {
    kg_composites(cc, col);
  } else if (w == 2) {     // in the order their levels arrive
    kg_walk(cc, col, 6);
    kg_walk(cc, col, 3);
    kg_walk(cc, col, 2);
  } else if (w != 5) {     // warp 5 idle: warp 1's scheduler is warp 1's
    // warp 0: link 6; warps 3, 4, 6, 8: links 5, 4, 3, 2; warp 7: links 0 and 1
    if (w == 7) kg_link(cc, col, 0);
    kg_link(cc, col, w == 0 ? 6 : (w == 3 ? 5 : (w == 4 ? 4 : (w == 6 ? 3 : (w == 8 ? 2 : 1)))));
    if (w == 0) {
      kg_bar_sync(KG_BAR_LINKS, KG_RNEA_WARPS * KG_LANES);
      kg_backward(cc, col);
    } else {
      kg_bar_arrive(KG_BAR_LINKS, KG_RNEA_WARPS * KG_LANES);
      if (w == 7) {
        kg_walk(cc, col, 5);
        kg_walk(cc, col, 4);
        kg_walk(cc, col, 1);
      }
    }
  }
}

#ifdef KG_PHASE_CLOCKS
#define KG_N_CLOCKS 4
// lane 0 of every warp of block 0 records clock64() as it leaves a stage
#define KG_CLOCK(clk, w, k) \
  do { if ((clk) != nullptr && (threadIdx.x & 31) == 0 && blockIdx.x == 0) \
         (clk)[(k) * KG_WARPS + (w)] = clock64(); } while (0)
#else
#define KG_CLOCK(clk, w, k)
#endif

// The stages after kg_trig: the column's KG_X, KG_TAU, KG_CQ and KG_SQ must
// be written and a block barrier passed.  Ends with qdd in KG_QDD and NO
// barrier: the caller places one before another thread reads it.
template <typename T>
__device__ __forceinline__ void kuka_qdd_group_after_trig(const float* __restrict__ cc,
                                                          KgCol<T> col, int w,
                                                          long long* clk = nullptr) {
  KG_CLOCK(clk, w, 1);
  kg_stage_sweeps(cc, col, w);
  KG_CLOCK(clk, w, 2);
  kg_sync_block();
  if (w == 0) kg_solve(col);
  KG_CLOCK(clk, w, 3);
}

// qdd of the column's x, tau (written, barrier passed) into KG_QDD; no
// barrier at the end.
template <typename T>
__device__ __forceinline__ void kuka_qdd_group(const float* __restrict__ cc, KgCol<T> col, int w,
                                               long long* clk = nullptr) {
  KG_CLOCK(clk, w, 0);
  kg_trig(col, w);
  kg_sync_block();
  kuka_qdd_group_after_trig(cc, col, w, clk);
}
