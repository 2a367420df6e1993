// Kuka iiwa-14 forward dynamics qdd = M^{-1}(tau - C) as one device function,
// templated on the scalar type.
//
// This is `models/kuka/soa.py::qdd_channels` written out by hand in C++: the
// same RNEA bias sweep (gravity as base acceleration), the same CRBA mass
// matrix and the same unrolled 7x7 Cholesky solve, step for step, in one
// thread.  The kernels (qdd.cu, sim_chain.cu, rollout.cu, rbd_jac.cu) run the
// same formulas split over a thread group (kuka_soa_group.cuh, built on the
// helpers here), on float and on the dual number defined below, which
// carries one forward-mode tangent; kuka_qdd itself is what the group core
// is held to on the host (tests/test_torch_group_core.py,
// tests/test_torch_chain_group.py) and what scripts/torch_dynamics_phases.py
// times beside it.
//
// Differences from the Python core, all in rounding only:
//   * the Python core skips the zero entries of the spatial inertias when it
//     builds its graph; here they are multiplied (a product with an exact 0
//     adds an exact 0);
//   * nvcc contracts a*b+c into fused multiply-adds.
// The composite inertias are accumulated leaf to root as in the Python core,
// but each mass-matrix column is emitted as soon as its composite inertia is
// final, so only two composite inertias are live at a time (fewer registers).
//
// Every joint of this chain is revolute about its local z axis (the Kuka
// iiwa-14); the prismatic branches of the generic Python core are not needed.
//
// The chain constants are read from a small device array (KC_SIZE floats, the
// layout of `soa._Consts.flat()`), not baked in as literals.
#pragma once

#include <cuda_runtime.h>

#define KUKA_NJ 7
#define KC_R 0                         // r_tree   (7, 3, 3)
#define KC_P (KC_R + 9 * KUKA_NJ)      // p_tree   (7, 3)
#define KC_I (KC_P + 3 * KUKA_NJ)      // i_spatial (7, 6, 6)
#define KC_EE (KC_I + 36 * KUKA_NJ)    // ee_offset (3)
#define KC_G (KC_EE + 3)               // gravity
#define KC_SIZE (KC_G + 1)

// Built with -DKUKA_PHASE_CLOCKS (scripts/torch_dynamics_phases.py only),
// thread 0 of block 0 records clock64() at the phase boundaries of kuka_qdd.
#ifdef KUKA_PHASE_CLOCKS
#define KUKA_N_CLOCKS 7
__device__ long long kuka_phase_clk[KUKA_N_CLOCKS];
#define KUKA_CLOCK(k) \
  do { if (threadIdx.x == 0 && blockIdx.x == 0) kuka_phase_clk[k] = clock64(); } while (0)
#else
#define KUKA_CLOCK(k)
#endif

// ---------------------------------------------------------------- scalars --

// Forward-mode dual number: value and one tangent (8-byte aligned: one
// 64-bit access where it lives in shared memory).
struct __align__(8) Dual {
  float v, d;
  __device__ __forceinline__ Dual() : v(0.f), d(0.f) {}
  __device__ __forceinline__ Dual(float value) : v(value), d(0.f) {}
  __device__ __forceinline__ Dual(float value, float tangent) : v(value), d(tangent) {}
};

__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return Dual(a.v + b.v, a.d + b.d); }
__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return Dual(a.v - b.v, a.d - b.d); }
__device__ __forceinline__ Dual operator-(Dual a) { return Dual(-a.v, -a.d); }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) { return Dual(a.v * b.v, a.d * b.v + a.v * b.d); }
__device__ __forceinline__ Dual operator*(float a, Dual b) { return Dual(a * b.v, a * b.d); }
__device__ __forceinline__ Dual operator*(Dual a, float b) { return Dual(a.v * b, a.d * b); }
__device__ __forceinline__ Dual operator+(Dual a, float b) { return Dual(a.v + b, a.d); }
__device__ __forceinline__ Dual operator+(float a, Dual b) { return Dual(a + b.v, b.d); }
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  float q = a.v / b.v;
  return Dual(q, (a.d - q * b.d) / b.v);
}
__device__ __forceinline__ Dual operator/(float a, Dual b) {
  float q = a / b.v;
  return Dual(q, -q * b.d / b.v);
}

__device__ __forceinline__ float s_sin(float a) { return sinf(a); }
__device__ __forceinline__ float s_cos(float a) { return cosf(a); }
__device__ __forceinline__ float s_sqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ Dual s_sin(Dual a) { return Dual(sinf(a.v), a.d * cosf(a.v)); }
__device__ __forceinline__ Dual s_cos(Dual a) { return Dual(cosf(a.v), -a.d * sinf(a.v)); }
__device__ __forceinline__ Dual s_sqrt(Dual a) {
  float r = sqrtf(a.v);
  return Dual(r, a.d * (0.5f / r));
}

// --------------------------------------------------------------- 3-vectors --

template <typename T>
__device__ __forceinline__ void v_cross(const T a[3], const T b[3], T out[3]) {
  T o0 = a[1] * b[2] - a[2] * b[1];
  T o1 = a[2] * b[0] - a[0] * b[2];
  T o2 = a[0] * b[1] - a[1] * b[0];
  out[0] = o0; out[1] = o1; out[2] = o2;
}

// out = m v
template <typename T>
__device__ __forceinline__ void m_vec(const T m[3][3], const T v[3], T out[3]) {
  T o[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = m[i][0] * v[0] + m[i][1] * v[1] + m[i][2] * v[2];
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = o[i];
}

// out = m^T v
template <typename T>
__device__ __forceinline__ void mT_vec(const T m[3][3], const T v[3], T out[3]) {
  T o[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = m[0][i] * v[0] + m[1][i] * v[1] + m[2][i] * v[2];
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = o[i];
}

// out = a b
template <typename T>
__device__ __forceinline__ void m_mul(const T a[3][3], const T b[3][3], T out[3][3]) {
  T o[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) o[i][j] = a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) out[i][j] = o[i][j];
}

template <typename T>
__device__ __forceinline__ void m_T(const T a[3][3], T out[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) out[i][j] = a[j][i];
}

// r_cl = R_tree[i] Rz(q_i): col0 = c Rt[:,0] + s Rt[:,1]; col1 = -s Rt[:,0] + c Rt[:,1]; col2 = Rt[:,2]
template <typename T>
__device__ __forceinline__ void local_rot(const float* __restrict__ cc, int i, T c, T s, T r[3][3]) {
  const float* rt = cc + KC_R + 9 * i;
#pragma unroll
  for (int row = 0; row < 3; ++row) {
    r[row][0] = c * rt[3 * row + 0] + s * rt[3 * row + 1];
    r[row][1] = (-s) * rt[3 * row + 0] + c * rt[3 * row + 1];
    r[row][2] = T(rt[3 * row + 2]);
  }
}

// spatial force (n, f) from child to parent coordinates: f' = r f; n' = r n + p x f'
template <typename T>
__device__ __forceinline__ void force_to_parent(const T r[3][3], const float* __restrict__ p,
                                                T n[3], T f[3]) {
  T fp[3], np_[3], pv[3] = {T(p[0]), T(p[1]), T(p[2])}, pxf[3];
  m_vec(r, f, fp);
  m_vec(r, n, np_);
  v_cross(pv, fp, pxf);
#pragma unroll
  for (int i = 0; i < 3; ++i) { n[i] = np_[i] + pxf[i]; f[i] = fp[i]; }
}

// out = I v for a constant 6x6 spatial inertia (row-major, 36 floats)
template <typename T>
__device__ __forceinline__ void i_mul6(const float* __restrict__ ii, const T v[6], T out[6]) {
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    T acc = ii[6 * r] * v[0];
#pragma unroll
    for (int c = 1; c < 6; ++c) acc = acc + ii[6 * r + c] * v[c];
    out[r] = acc;
  }
}

// ------------------------------------------------------------ the dynamics --

// qdd (7) from q, qd, tau (7 each).
template <typename T>
__device__ void kuka_qdd(const float* __restrict__ cc, const T q[KUKA_NJ], const T qd[KUKA_NJ],
                         const T tau[KUKA_NJ], T qdd[KUKA_NJ]) {
  const int n = KUKA_NJ;
  KUKA_CLOCK(0);
  T cq[KUKA_NJ], sq[KUKA_NJ];
#pragma unroll
  for (int i = 0; i < n; ++i) { cq[i] = s_cos(q[i]); sq[i] = s_sin(q[i]); }
  KUKA_CLOCK(1);

  // --- forward sweep: velocities and bias accelerations (qdd = 0) ---
  T w[3] = {T(0.f), T(0.f), T(0.f)};
  T v[3] = {T(0.f), T(0.f), T(0.f)};
  T dw[3] = {T(0.f), T(0.f), T(0.f)};
  T dv[3] = {T(0.f), T(0.f), T(cc[KC_G])};
  T f_link[KUKA_NJ][6];
#pragma unroll
  for (int i = 0; i < n; ++i) {
    T r[3][3];
    local_rot(cc, i, cq[i], sq[i], r);
    const float* p = cc + KC_P + 3 * i;
    T pv[3] = {T(p[0]), T(p[1]), T(p[2])};
    T t[3];
    // v = r^T (v + w x p); w = r^T w; dv = r^T (dv + dw x p); dw = r^T dw
    v_cross(w, pv, t);
    t[0] = v[0] + t[0]; t[1] = v[1] + t[1]; t[2] = v[2] + t[2];
    mT_vec(r, t, v);
    mT_vec(r, w, w);
    v_cross(dw, pv, t);
    t[0] = dv[0] + t[0]; t[1] = dv[1] + t[1]; t[2] = dv[2] + t[2];
    mT_vec(r, t, dv);
    mT_vec(r, dw, dw);
    // velocity-product acceleration of the revolute joint (S = e3 angular)
    T s = qd[i];
    dw[0] = dw[0] + w[1] * s; dw[1] = dw[1] + (-w[0]) * s;
    dv[0] = dv[0] + v[1] * s; dv[1] = dv[1] + (-v[0]) * s;
    w[2] = w[2] + s;

    // per-link bias force: f = I a + v x* (I v)
    const float* ii = cc + KC_I + 36 * i;
    T mv[6] = {w[0], w[1], w[2], v[0], v[1], v[2]};
    T ma[6] = {dw[0], dw[1], dw[2], dv[0], dv[1], dv[2]};
    T iv[6], fa[6];
    i_mul6(ii, mv, iv);
    i_mul6(ii, ma, fa);
    T c1[3], c2[3], c3[3];
    v_cross(w, iv, c1);       // w x (I v)[:3]
    v_cross(v, iv + 3, c2);   // v x (I v)[3:]
    v_cross(w, iv + 3, c3);   // w x (I v)[3:]
    f_link[i][0] = fa[0] + (c1[0] + c2[0]);
    f_link[i][1] = fa[1] + (c1[1] + c2[1]);
    f_link[i][2] = fa[2] + (c1[2] + c2[2]);
    f_link[i][3] = fa[3] + c3[0];
    f_link[i][4] = fa[4] + c3[1];
    f_link[i][5] = fa[5] + c3[2];
  }

  KUKA_CLOCK(2);
  // --- backward sweep: bias torques ---
  T c_bias[KUKA_NJ];
  {
    T n_acc[3] = {T(0.f), T(0.f), T(0.f)};
    T f_acc[3] = {T(0.f), T(0.f), T(0.f)};
#pragma unroll
    for (int i = n - 1; i >= 0; --i) {
      T nt[3], ft[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) { nt[k] = f_link[i][k] + n_acc[k]; ft[k] = f_link[i][3 + k] + f_acc[k]; }
      c_bias[i] = nt[2];
      T r[3][3];
      local_rot(cc, i, cq[i], sq[i], r);
      force_to_parent(r, cc + KC_P + 3 * i, nt, ft);
#pragma unroll
      for (int k = 0; k < 3; ++k) { n_acc[k] = nt[k]; f_acc[k] = ft[k]; }
    }
  }

  KUKA_CLOCK(3);
  // --- CRBA: composite inertia ic = [[A, B], [B^T, D]], leaf to root ---
  T M[KUKA_NJ][KUKA_NJ];
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
  for (int i = n - 1; i >= 0; --i) {
    // ic[i] is final: emit mass-matrix column i.  F = Ic_i [e3; 0] = [A[:,2]; B[2,:]]
    {
      T nf[3] = {A[0][2], A[1][2], A[2][2]};
      T ff[3] = {Bm[2][0], Bm[2][1], Bm[2][2]};
      M[i][i] = nf[2];
#pragma unroll
      for (int j = i - 1; j >= 0; --j) {
        T r[3][3];
        local_rot(cc, j + 1, cq[j + 1], sq[j + 1], r);
        force_to_parent(r, cc + KC_P + 3 * (j + 1), nf, ff);
        M[i][j] = nf[2];
        M[j][i] = nf[2];
      }
    }
    if (i == 0) break;
    // ic[i-1] = I[i-1] + X^T ic[i] X with X = [[R, 0], [S, R]], R = r^T, S = -r^T p^
    T r[3][3], rt[3][3], sk[3][3], s_m[3][3];
    local_rot(cc, i, cq[i], sq[i], r);
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
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        A[a][b] = ii[6 * a + b] + (((tl[a][b] + e_m[a][b]) + e_m[b][a]) + sds[a][b]);
        Bm[a][b] = ii[6 * a + 3 + b] + (tr[a][b] + sdr[a][b]);
        D[a][b] = ii[6 * (3 + a) + 3 + b] + br[a][b];
      }
  }

  KUKA_CLOCK(4);
  // --- qdd = M^{-1} (tau - C) by unrolled Cholesky (soa._chol_solve7) ---
  T L[KUKA_NJ][KUKA_NJ];
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
  KUKA_CLOCK(5);
  T z[KUKA_NJ];
#pragma unroll
  for (int i = 0; i < n; ++i) {
    T acc = tau[i] - c_bias[i];
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
  KUKA_CLOCK(6);
}

// Continuous xdot = [qd; qdd] for x = [q; qd] (ops/integrators.py _xdot).
template <typename T>
__device__ __forceinline__ void kuka_xdot(const float* __restrict__ cc, const T x[2 * KUKA_NJ],
                                          const T u[KUKA_NJ], T xd[2 * KUKA_NJ]) {
  T qdd[KUKA_NJ];
  kuka_qdd(cc, x, x + KUKA_NJ, u, qdd);
#pragma unroll
  for (int i = 0; i < KUKA_NJ; ++i) { xd[i] = x[KUKA_NJ + i]; xd[KUKA_NJ + i] = qdd[i]; }
}
