// RBD Jacobian kernel: d qdd / d [x; u] (B, 7, 21) and the primal qdd (B, 7)
// of the Kuka iiwa-14 forward dynamics for a batch of samples, and, for the
// Euler integrator, the discrete AB = E + dt [[0 I 0]; [J]] (B, 14, 21)
// straight from the same launch.
//
// Replaces: parallel_ddp_tpu/ops/pallas_rbd.py::_jac_kernel (pallas_call at
// pallas_rbd.py:94), which runs jax.linearize of soa.qdd_channels and applies
// the 21 unit tangents on (8, 128) lane tiles.
//
// Forward mode by a dual number (value, tangent) as the scalar of the soa
// dynamics: one evaluation per (sample, tangent column j in 0..20), which
// seeds tangent 1 on input j and yields column j of the Jacobian (and, for
// j = 0, the primal).  Not an analytic RNEA-derivative formula: the result
// is the plain version's forward-mode chain up to rounding.
//
// What bounds it on the H100: at the main path's B = N-1 = 63 samples there
// are 1,323 evaluations of a ~4k-operation dataflow on 84 bytes in and 616
// bytes out a sample: latency-bound by one evaluation's serial chain.  The
// first version ran that chain in one thread.
//
// Design: the group core (kuka_soa_group.cuh) on Dual.  A block of KG_WARPS
// warps takes 32 evaluations, lane l of every warp evaluation l, so the roles of
// an evaluation run side by side in the warps and its chain is the longest
// role of each stage.  63 samples make 42 blocks on 42 SMs.  Warp w < 7
// seeds and takes cos/sin of joint w, and at the end stores row w of the
// outputs: neighbouring lanes are neighbouring columns j of one row, so the
// stores of a warp are contiguous.
//
// The Euler epilogue writes AB with a separate multiply and add
// (__fmul_rn, __fadd_rn), which is what the composer's two tensor operations
// E + dt * F compute on the same J, bit for bit; the derivative stage then
// needs no further launch.

#include <cuda_runtime.h>

#include "kuka_soa_group.cuh"

#define RBD_NX (2 * KUKA_NJ)
#define RBD_NIN (3 * KUKA_NJ)

// jac, qdd and ab may each be null: that output is not written.
__global__ void __launch_bounds__(KG_THREADS)
rbd_jac_kernel(const float* __restrict__ cc_g, const float* __restrict__ x,
               const float* __restrict__ u, float* __restrict__ jac, float* __restrict__ qdd,
               float* __restrict__ ab, int batch, float dt) {
  __shared__ float cc[KC_SIZE];
  __shared__ __align__(8) float ws_raw[2 * KG_FIELDS * KG_LANES];
  const int lane = threadIdx.x & (KG_LANES - 1), w = threadIdx.x >> 5;
  const int total = batch * RBD_NIN;
  const int g = blockIdx.x * KG_LANES + lane;
  const bool valid = g < total;
  const int gc = valid ? g : total - 1;        // spare lanes repeat the last one, store nothing
  const int b = gc / RBD_NIN;
  const int j = gc - b * RBD_NIN;

  for (int i = threadIdx.x; i < KC_SIZE; i += KG_THREADS) cc[i] = cc_g[i];
  KgCol<Dual> col{reinterpret_cast<Dual*>(ws_raw) + lane};
  if (w < KUKA_NJ) {
    col[KG_X + w] = Dual(x[b * RBD_NX + w], j == w ? 1.f : 0.f);
    col[KG_X + KUKA_NJ + w] =
        Dual(x[b * RBD_NX + KUKA_NJ + w], j == KUKA_NJ + w ? 1.f : 0.f);
    col[KG_TAU + w] = Dual(u[b * KUKA_NJ + w], j == RBD_NX + w ? 1.f : 0.f);
    kg_trig(col, w);
  }
  __syncthreads();
  kuka_qdd_group_after_trig(cc, col, w);
  __syncthreads();

  if (valid && w < KUKA_NJ) {
    const Dual o = col[KG_QDD + w];
    if (jac != nullptr) jac[(b * KUKA_NJ + w) * RBD_NIN + j] = o.d;
    if (qdd != nullptr && j == 0) qdd[b * KUKA_NJ + w] = o.v;
    if (ab != nullptr) {
      // xdot = [qd; qdd]: row w of F is the unit row of qd_w, row 7 + w is J's
      float* rows = ab + (size_t)b * RBD_NX * RBD_NIN;
      rows[w * RBD_NIN + j] =
          __fadd_rn(j == w ? 1.f : 0.f, __fmul_rn(dt, j == KUKA_NJ + w ? 1.f : 0.f));
      rows[(KUKA_NJ + w) * RBD_NIN + j] =
          __fadd_rn(j == KUKA_NJ + w ? 1.f : 0.f, __fmul_rn(dt, o.d));
    }
  }
}

// x (B, 14), u (B, 7) -> jac (B, 7, 21), qdd (B, 7), ab (B, 14, 21); a null
// output pointer leaves that output out.  dt is used by ab only.  A batched
// solve flattens its scenarios into B (4096 scenarios: 258,048 samples,
// 169,344 blocks); the int indices above hold while B * 14 * 21 fits an int.
extern "C" int pddp_rbd_jac(const float* consts, const float* x, const float* u, float* jac,
                            float* qdd, float* ab, int batch, float dt, void* stream) {
  if (batch <= 0) return 0;
  if (batch > 0x7fffffff / (RBD_NX * RBD_NIN)) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (batch * RBD_NIN + KG_LANES - 1) / KG_LANES;
  rbd_jac_kernel<<<blocks, KG_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      consts, x, u, jac, qdd, ab, batch, dt);
  return static_cast<int>(cudaGetLastError());
}
