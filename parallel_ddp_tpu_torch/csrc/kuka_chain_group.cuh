// The simulation chain on the thread group: T dependent integrator steps of
// the Kuka iiwa-14 for the 32 chains of a block of KG_WARPS warps, the time
// loop inside, every state written out (sim_chain.cu is one call of ch_chain
// a thread).  The group of chain l is lane l of every warp, as in
// kuka_soa_group.cuh, whose roles evaluate the dynamics; this header adds
// what the chain does around them.
//
// Warp w < 7 owns state elements w and 7 + w of its lane's chain: it keeps
// them in registers over the steps, does the integrator's update for them,
// takes cos/sin of joint w and, in open-loop mode, loads control w of the
// next step one step ahead.  Each warp stores its element of the 32 chains
// as it is made, off the chain.
//
// Two control sources:
//   (a) open loop: chain b applies u[b, k] at step k;
//   (b) trajectory runner (one chain): step k applies the control law of
//       mpc/device_loop.py::get_hardware_controls at the plant clock t_k =
//       t + k sim_dt from the plan (x, u, K rows, t0, dt): index clamp,
//       first-order hold on x, zero-order hold on u and K, u = u_k - K_k
//       (x - x_ref).  The RNEA warps with the shortest sweeps compute its 7
//       rows (warp 8 rows 0-2, warp 6 rows 3-4, warp 4 row 5, warp 3 row 6)
//       before they arrive at the links barrier, behind which warp 0 needs
//       them.  Every thread advances its own copy of the clock with the same
//       float additions, so all hold the same t.
//
// Two schedules:
//   in step (every integrator): a step is a dynamics evaluation per
//       integrator stage, each the group core's three stages (trig with the
//       state update, sweeps, solve), three block barriers an evaluation.
//   one step ahead (Euler only): q_{k+1} = q_k + h qd_k does not wait for
//       qdd_k, so M(q_{k+1}), the composites, walks and factor, is computed
//       while step k's RNEA and substitutions run:
//         stage P_k   RNEA warps 0, 3, 4, 6, 7, 8: step k's link forces and
//                       bias torques on trig set k & 1; warp 0 then the two
//                       substitutions with L_k, set k & 1, into qdd_k;
//                     warp 1: step k+1's composites on trig set (k+1) & 1,
//                       warps 2 and 7 (after its links): its column walks,
//                       warp 5: its factor L_{k+1} into set (k+1) & 1, once
//                       the three have arrived at KG_BAR_FACTOR;
//         stage U_k   warps w < 7: qd_{k+1} = qd_k + h qdd_k, q_{k+1} (made a
//                       step ago), q_{k+2} = q_{k+1} + h qd_{k+1} and its
//                       cos/sin into set k & 1.
//       Two block barriers a step.  The trig and the factor are kept in two
//       sets (CH_TRIG1 beside the core's KG_CQ / KG_SQ, CH_L0 / CH_L1); M
//       itself is written and factored inside one stage.
//
// Every scalar is computed by one thread with the expressions of kuka_soa.cuh
// and of ops/integrators.py make_step in their order: the two schedules run
// the same expressions on the same operands, so they agree bit for bit, and on
// the host (tests/test_torch_chain_group.py, no contraction) both equal a
// one-thread step on kuka_soa.cuh::kuka_xdot.
#pragma once

#include "kuka_soa_group.cuh"

#define CH_NS (2 * KUKA_NJ)
#define CH_TRI (KUKA_NJ * (KUKA_NJ + 1) / 2)    // a lower triangle with its diagonal

// the chain's fields of a column, after the group core's
#define CH_TRIG1 KG_FIELDS                      // trig set 1: cos q (7), sin q (7)
#define CH_L0 (CH_TRIG1 + 2 * KUKA_NJ)          // L of M, set 0: L[i][j], j <= i, at i(i+1)/2 + j
#define CH_L1 (CH_L0 + CH_TRI)                  // set 1
#define CH_FIELDS (CH_L1 + CH_TRI)

// floats of one knot of a runner's plan: x (14), u (7), K (7 x 14)
#define CH_KNOT (CH_NS + KUKA_NJ + KUKA_NJ * CH_NS)

#define KG_BAR_FACTOR 8                         // warps 1, 2, 7 and 5: M is written
#define CH_FACTOR_WARP 5                        // idle in the core: warp 1's scheduler

__device__ __forceinline__ int ch_trig_set(int s) { return s ? CH_TRIG1 : KG_CQ; }
__device__ __forceinline__ int ch_l_set(int s) { return s ? CH_L1 : CH_L0; }

// The runner's plan: its knots in device memory, and rows [base, base + rows)
// of them also staged in shared memory.
struct ChPlan {
  const float* x;        // (n, 14)
  const float* u;        // (n, 7)
  const float* K;        // (n, 7, 14)
  const float* sx;       // the staged rows of each
  const float* su;
  const float* sK;
  int base, rows, n;
  float t0, dt;          // the plan's start time and knot step
  int feedback;
};

struct ChArgs {
  const float* x0;       // (B, 14)
  const float* u;        // (B, T, 7) in mode (a); null in mode (b)
  float* xs;             // (B, T, 14)
  float* t_out;          // mode (b): the clock after the T steps
  int T;
  float h, h_half, h_sixth;   // the step, 0.5 step and step / 6, rounded to float
  float sim_dt;          // mode (b): the clock's advance a step
  float t;               // mode (b): the clock at the first step
  ChPlan plan;
};

// get_hardware_controls' knot at clock t: the index clamped to [0, n - 2] (a
// NaN clock indexes knot 0, as the cast does there) and the weight of the
// next knot, clamped to [0, 1]
__device__ __forceinline__ int ch_knot(const ChPlan& p, float t, float& frac) {
  const float rel = (t - p.t0) / p.dt;
  float fi = floorf(rel);
  fi = fminf(fmaxf(fi, 0.f), (float)(p.n - 2));
  frac = rel - fi;
  frac = frac < 0.f ? 0.f : (frac > 1.f ? 1.f : frac);
  return (int)fi;
}

// Mode (b)'s knots in shared memory: those the T steps' clock can index, the
// next one, and one of margin for the clock's rounding (a knot outside the
// window is read from device memory, so the count only sets what is fast);
// at most n.  Host side: it sizes the launch's shared memory.
inline int ch_plan_rows(int T, float sim_dt, float traj_dt, int n) {
  const double span = (T - 1) * static_cast<double>(sim_dt) / traj_dt;
  const int rows = span >= 0.0 && span < n ? static_cast<int>(span) + 3 : n;
  return rows < n ? rows : n;
}

// Mode (b)'s start, by thread tid of the block's nthreads: the clocks from
// device memory, the window from the first step's knot on (the clock only
// moves on), and this thread's share of its staging into sx, su, sK (read
// after the first block barrier).
__device__ __forceinline__ void ch_runner_start(ChArgs& a, const float* t0_ptr,
                                                const float* t_ptr, float* sx, float* su,
                                                float* sK, int tid, int nthreads) {
  ChPlan& p = a.plan;
  a.t = t_ptr[0];
  p.t0 = t0_ptr[0];
  float frac;
  const int first = ch_knot(p, a.t, frac);
  p.base = first < p.n - p.rows ? first : p.n - p.rows;
  const size_t base = p.base;
  for (int i = tid; i < p.rows * CH_NS; i += nthreads) sx[i] = p.x[base * CH_NS + i];
  for (int i = tid; i < p.rows * KUKA_NJ; i += nthreads) su[i] = p.u[base * KUKA_NJ + i];
  for (int i = tid; i < p.rows * KUKA_NJ * CH_NS; i += nthreads)
    sK[i] = p.K[base * KUKA_NJ * CH_NS + i];
  p.sx = sx;
  p.su = su;
  p.sK = sK;
}

// knot k's row of one plan array: staged where it is, else in device memory
__device__ __forceinline__ const float* ch_row(const ChPlan& p, const float* staged,
                                               const float* global, int k, int width) {
  const int r = k - p.base;
  return (r >= 0 && r < p.rows) ? staged + r * width : global + (size_t)k * width;
}

// control i of the column's x at knot ind (sim_chain's expressions in their order)
__device__ __forceinline__ float ch_control(const ChPlan& p, KgCol<float> col, int ind, float frac,
                                            int i) {
  const float uk = ch_row(p, p.su, p.u, ind, KUKA_NJ)[i];
  if (!p.feedback) return uk;
  const float* xa = ch_row(p, p.sx, p.x, ind, CH_NS);
  const float* xb = ch_row(p, p.sx, p.x, ind + 1, CH_NS);
  const float* Kr = ch_row(p, p.sK, p.K, ind, KUKA_NJ * CH_NS) + i * CH_NS;
  const float w0 = 1.0f - frac;
  float fb = Kr[0] * (col[KG_X] - (w0 * xa[0] + frac * xb[0]));
#pragma unroll
  for (int j = 1; j < CH_NS; ++j) fb = fb + Kr[j] * (col[KG_X + j] - (w0 * xa[j] + frac * xb[j]));
  return uk - fb;
}

// the control rows of RNEA warp w at clock t into KG_TAU
__device__ __forceinline__ void ch_control_rows(const ChPlan& p, KgCol<float> col, int w,
                                                float t) {
  const int lo = w == 8 ? 0 : (w == 6 ? 3 : (w == 4 ? 5 : (w == 3 ? 6 : KUKA_NJ)));
  const int hi = w == 8 ? 3 : (w == 6 ? 5 : (w == 4 ? 6 : KUKA_NJ));
  if (lo >= hi) return;
  float frac;
  const int ind = ch_knot(p, t, frac);
  for (int i = lo; i < hi; ++i) col[KG_TAU + i] = ch_control(p, col, ind, frac, i);
}

__device__ __forceinline__ void ch_store_l(KgCol<float> col, int lb,
                                           const float L[KUKA_NJ][KUKA_NJ]) {
#pragma unroll
  for (int i = 0; i < KUKA_NJ; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) col[lb + i * (i + 1) / 2 + j] = L[i][j];
}

__device__ __forceinline__ void ch_load_l(KgCol<float> col, int lb, float L[KUKA_NJ][KUKA_NJ]) {
#pragma unroll
  for (int i = 0; i < KUKA_NJ; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) L[i][j] = col[lb + i * (i + 1) / 2 + j];
}

// cos/sin of q_w into trig set s
__device__ __forceinline__ void ch_trig(KgCol<float> col, int s, int w, float q) {
  const int tb = ch_trig_set(s);
  col[tb + w] = s_cos(q);
  col[tb + KUKA_NJ + w] = s_sin(q);
}

// One stage of the dynamics, called by every thread of the block with its
// warp w.  Each part is on or off for the whole block:
//   rnea >= 0  the RNEA on trig set rnea: the link forces, then (ctl) the
//              runner's control rows of plan p at clock t, then warp 0's backward
//              sweep to the bias torques and, where subs >= 0, its two
//              substitutions with L set subs into KG_QDD;
//   crba >= 0  the composites and column walks on trig set crba into KG_FN,
//              KG_FF and KG_M, and, where factor >= 0, warp 5's factor of M
//              into L set factor.
// No barrier at the end.
__device__ __forceinline__ void ch_stage(const float* __restrict__ cc, KgCol<float> col, int w,
                                         int rnea, int crba, int subs, int factor, bool ctl,
                                         const ChPlan& p, float t) {
  const bool fac = factor >= 0;
  if (w == 1) {
    if (crba >= 0) kg_composites(cc, col, ch_trig_set(crba));
    if (fac) kg_bar_arrive(KG_BAR_FACTOR, 4 * KG_LANES);
  } else if (w == 2) {     // in the order their levels arrive
    if (crba >= 0) {
      const int tb = ch_trig_set(crba);
      kg_walk(cc, col, 6, tb);
      kg_walk(cc, col, 3, tb);
      kg_walk(cc, col, 2, tb);
    }
    if (fac) kg_bar_arrive(KG_BAR_FACTOR, 4 * KG_LANES);
  } else if (w == CH_FACTOR_WARP) {
    if (fac) {
      kg_bar_sync(KG_BAR_FACTOR, 4 * KG_LANES);
      float L[KUKA_NJ][KUKA_NJ];
      kg_factor(col, L);
      ch_store_l(col, ch_l_set(factor), L);
    }
  } else {                 // warp 0: link 6; 3, 4, 6, 8: links 5..2; 7: links 0 and 1
    if (rnea >= 0) {
      const int tb = ch_trig_set(rnea);
      if (w == 7) kg_link(cc, col, 0, tb);
      kg_link(cc, col, w == 0 ? 6 : (w == 3 ? 5 : (w == 4 ? 4 : (w == 6 ? 3 : (w == 8 ? 2 : 1)))),
              tb);
      if (ctl) ch_control_rows(p, col, w, t);
      if (w == 0) {
        kg_bar_sync(KG_BAR_LINKS, KG_RNEA_WARPS * KG_LANES);
        kg_backward(cc, col, tb);
        if (subs >= 0) {
          float L[KUKA_NJ][KUKA_NJ];
          ch_load_l(col, ch_l_set(subs), L);
          kg_subs(col, L);
        }
      } else {
        kg_bar_arrive(KG_BAR_LINKS, KG_RNEA_WARPS * KG_LANES);
      }
    }
    if (w == 7) {
      if (crba >= 0) {
        const int tb = ch_trig_set(crba);
        kg_walk(cc, col, 5, tb);
        kg_walk(cc, col, 4, tb);
        kg_walk(cc, col, 1, tb);
      }
      if (fac) kg_bar_arrive(KG_BAR_FACTOR, 4 * KG_LANES);
    }
  }
}

// qdd of the column's x (trig set 0 written and a block barrier passed) into
// KG_QDD, and a block barrier: every thread may read it.
__device__ __forceinline__ void ch_eval(const float* __restrict__ cc, KgCol<float> col, int w,
                                        bool ctl, const ChPlan& p, float t) {
  ch_stage(cc, col, w, 0, 0, -1, -1, ctl, p, t);
  kg_sync_block();
  if (w == 0) kg_solve(col);
  kg_sync_block();
}

// The chain of one lane: every thread of the block calls it with its warp w,
// the index b of its lane's chain and whether that chain is stored (a lane
// past the batch runs a copy of the last chain and writes nothing).  The
// constants and, in mode (b), the staged plan rows must be in place by the
// first block barrier.  INTEG: 1 Euler, 2 Midpoint, 3 RK3; AHEAD (Euler only):
// the one-step-ahead schedule.
template <int INTEG, bool AHEAD>
__device__ __forceinline__ void ch_chain(const float* __restrict__ cc, KgCol<float> col, int w,
                                         const ChArgs& a, int b, bool store) {
  static_assert(!AHEAD || INTEG == 1, "only the Euler chain runs a step ahead");
  const bool runner = a.u == nullptr;
  const ChPlan& p = a.plan;
  const int T = a.T;
  const float h = a.h;
  const float* ub = runner ? nullptr : a.u + (size_t)b * T * KUKA_NJ;
  float* xo = a.xs + (size_t)b * T * CH_NS;
  float t = a.t;
  float xq = 0.f, xv = 0.f, un = 0.f;   // warp w < 7: x[w], x[7 + w]; the next step's u[w]
  if (w < KUKA_NJ) {
    xq = a.x0[(size_t)b * CH_NS + w];
    xv = a.x0[(size_t)b * CH_NS + KUKA_NJ + w];
    col[KG_X + w] = xq;
    col[KG_X + KUKA_NJ + w] = xv;
    ch_trig(col, 0, w, xq);
    if (!runner) {
      col[KG_TAU + w] = ub[w];
      if (T > 1) un = ub[KUKA_NJ + w];
    }
  }

  if (AHEAD) {
    float qn = 0.f;                      // q_{k+1}[w], made a step ahead
    if (w < KUKA_NJ) {
      qn = xq + h * xv;
      ch_trig(col, 1, w, qn);
    }
    kg_sync_block();
    ch_stage(cc, col, w, -1, 0, -1, 0, false, p, t);     // M(q_0) and its factor
    kg_sync_block();
    for (int k = 0; k < T; ++k) {
      const int s = k & 1;
      const int next = k + 1 < T ? s ^ 1 : -1;
      ch_stage(cc, col, w, s, next, s, next, runner, p, t);
      kg_sync_block();
      if (w < KUKA_NJ) {
        const float qdd = col[KG_QDD + w];
        xq = qn;
        xv = xv + h * qdd;
        if (store) {
          xo[(size_t)k * CH_NS + w] = xq;
          xo[(size_t)k * CH_NS + KUKA_NJ + w] = xv;
        }
        if (k + 1 < T) {
          col[KG_X + w] = xq;
          col[KG_X + KUKA_NJ + w] = xv;
          qn = xq + h * xv;
          ch_trig(col, s, w, qn);        // q_{k+2}: the set step k's RNEA read
          if (!runner) {
            col[KG_TAU + w] = un;
            if (k + 2 < T) un = ub[(size_t)(k + 2) * KUKA_NJ + w];
          }
        }
      }
      t = t + a.sim_dt;
      kg_sync_block();
    }
  } else {
    kg_sync_block();
    for (int k = 0; k < T; ++k) {
      ch_eval(cc, col, w, runner, p, t);
      // the integrator (ops/integrators.py make_step, formula for formula) on
      // this warp's elements: xdot = [qd; qdd]
      if (w < KUKA_NJ) {
        const float qdd = col[KG_QDD + w];
        if (INTEG == 1) {
          xq = xq + h * xv;
          xv = xv + h * qdd;
        }
      }
      if (INTEG != 1) {
        float k1q = 0.f, k1v = 0.f, k2q = 0.f, k2v = 0.f, sq = 0.f, sv = 0.f;
        if (w < KUKA_NJ) {
          k1q = xv;
          k1v = col[KG_QDD + w];
          sq = xq + a.h_half * k1q;
          sv = xv + a.h_half * k1v;
          col[KG_X + w] = sq;
          col[KG_X + KUKA_NJ + w] = sv;
          ch_trig(col, 0, w, sq);
        }
        kg_sync_block();
        ch_eval(cc, col, w, false, p, t);
        if (w < KUKA_NJ) {
          k2q = sv;
          k2v = col[KG_QDD + w];
        }
        if (INTEG == 2) {
          if (w < KUKA_NJ) {
            xq = xq + h * k2q;
            xv = xv + h * k2v;
          }
        } else {
          if (w < KUKA_NJ) {
            sq = xq + h * (2.0f * k2q - k1q);
            sv = xv + h * (2.0f * k2v - k1v);
            col[KG_X + w] = sq;
            col[KG_X + KUKA_NJ + w] = sv;
            ch_trig(col, 0, w, sq);
          }
          kg_sync_block();
          ch_eval(cc, col, w, false, p, t);
          if (w < KUKA_NJ) {
            const float k3v = col[KG_QDD + w];
            xq = xq + a.h_sixth * ((k1q + 4.0f * k2q) + sv);
            xv = xv + a.h_sixth * ((k1v + 4.0f * k2v) + k3v);
          }
        }
      }
      if (w < KUKA_NJ) {
        if (store) {
          xo[(size_t)k * CH_NS + w] = xq;
          xo[(size_t)k * CH_NS + KUKA_NJ + w] = xv;
        }
        col[KG_X + w] = xq;
        col[KG_X + KUKA_NJ + w] = xv;
        ch_trig(col, 0, w, xq);
        if (!runner) {
          col[KG_TAU + w] = un;
          if (k + 2 < T) un = ub[(size_t)(k + 2) * KUKA_NJ + w];
        }
      }
      t = t + a.sim_dt;
      kg_sync_block();
    }
  }
  if (runner && store && w == 0) *a.t_out = t;
}
