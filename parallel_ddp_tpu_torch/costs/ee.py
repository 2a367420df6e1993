"""End-effector pose cost family (twin of `parallel_ddp_tpu/costs/ee.py`;
cost_arm.cuh:204-390), evaluated over the time axis as a batch.

cost(k) = eeCost + 0.5*R_EE*|u|^2 (non-terminal) + nominal-state regularizer
          [+ joint pos/vel/torque limit penalties]

  eeCost = 0.5 * sum_i w_i(k) * (eePos_i - goal_i)^2   (+ EE-velocity terms)
           with w = (Q_EE1 xyz, Q_EE2 rpy) running / (QF_EE1, QF_EE2) for
           k >= N-1-cost_shift (cost_arm.cuh:206-222)
  smooth-abs option: eeCost -> sqrt(2*eeCost + a^2) - a
  nominal state: 0.5*(Q_xEE*|q - qt|^2 + Q_xdEE*|qd - qdt|^2), terminal on k == N-1
  limit penalties: 0.5*max(|v|-limit, 0)^2 scaled by Q_PL/Q_VL/R_TL

The Hessian is the reference's Gauss-Newton form H_qq = deePos^T deePos —
deliberately UNWEIGHTED (the commented-out `*factor` in cost_arm.cuh:358,366)
— plus the diagonal nominal/control/limit second derivatives.  deePos is the
plant's `ee_jac` (`Plant.ee_jac`); only the EE-velocity option's second
derivative d(deePos qd)/dq uses `torch.func`.

goal: {"ee_goal": (6,), "x_target": (n_state,)} tensors, optionally
"cost_shift" (live terminal-weight shift) and "ee_vel_goal" (6,).

w: the weights as data, never baked into the operations: a `CostWeights` of
0-d tensors (the solver's views of its weights tensor, `config.weights_of`),
or of numbers, which are put on x's device first.

On bfloat16 x and u (`SolverConfig.bf16_cost`) the stage keeps the JAX
package's dtypes: what meets the float32 goal or limits is float32, and a
weight times a bfloat16 term (|u|^2, the EE-velocity terms) is bfloat16, as
a JAX Python-float weight is weakly typed.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from parallel_ddp_tpu_torch.config import CostWeights, weights_of
from parallel_ddp_tpu_torch.costs.base import CostModel


def _quad_pen(v, limit):
    """0.5*max(|v|-limit,0)^2 and its first/second derivatives (cost_arm.cuh:66-77)."""
    delta = v.abs() - limit
    active = delta > 0
    zero = torch.zeros_like(delta)
    pen = torch.where(active, 0.5 * delta * delta, zero)
    dpen = torch.where(active, torch.sign(v) * delta, zero)
    d2pen = torch.where(active, torch.ones_like(delta), zero)
    return pen, dpen, d2pen


def _where(cond, a, b, shape=()):
    """Per-knot weight: a where cond else b (0-d tensors, or a number for
    one of them), broadcast over cond's shape and `shape`."""
    return torch.where(cond, a, b).expand(torch.broadcast_shapes(cond.shape, shape))


def ee_cost(
    ee_pos: Callable,
    ee_jac: Callable,
    n_pos: int,
    n_ctrl: int,
    num_time_steps: int,
    use_smooth_abs: bool = False,
    smooth_abs_alpha: float = 0.2,
    use_ee_vel: bool = False,
    use_limits: bool = False,
    pos_limits: Optional[np.ndarray] = None,
    vel_limits: Optional[np.ndarray] = None,
    torque_limits: Optional[np.ndarray] = None,
    final_cost_shift: int = 0,
) -> CostModel:
    """Build the EE cost model around a forward-kinematics map q -> (6,) pose
    that takes any leading batch dims, and its Jacobian
    q (..., n_pos) -> (..., 6, n_pos)."""

    nf = num_time_steps - 1
    n_state = 2 * n_pos
    limit_cache = {}

    def _limits(like):
        # float32 beside a bfloat16 x, as the JAX package's numpy limits
        key = (like.device, torch.promote_types(like.dtype, torch.float32))
        if key not in limit_cache:
            limit_cache[key] = tuple(
                torch.as_tensor(np.asarray(a), dtype=key[1], device=like.device)
                for a in (pos_limits, vel_limits, torque_limits))
        return limit_cache[key]

    def deev_dq(q, qd):
        """d (deePos(q) qd) / dq: (..., 6, n_pos)."""
        def eev(qq, qdd):
            return torch.func.jacfwd(ee_pos)(qq) @ qdd
        flat = torch.func.vmap(torch.func.jacfwd(eev))(
            q.reshape(-1, n_pos), qd.reshape(-1, n_pos))
        return flat.reshape(q.shape[:-1] + (6, n_pos))

    def _ee_weights(k, w: CostWeights, goal):
        # final-cost-shift: terminal EE weights switch on `cost_shift` steps
        # before the horizon end; a live value in the goal overrides the default
        shift = goal.get("cost_shift", final_cost_shift)
        terminal = (k >= nf - shift)[..., None]
        w_pos = torch.cat([_where(terminal, w.qf_ee1, w.q_ee1, (3,)),
                           _where(terminal, w.qf_ee2, w.q_ee2, (3,))], dim=-1)
        w_vel = torch.cat([_where(terminal, w.qf_eev1, w.q_eev1, (3,)),
                           _where(terminal, w.qf_eev2, w.q_eev2, (3,))], dim=-1)
        return w_pos, w_vel

    def _ee_terms(x, k, goal, w):
        q, qd = x[..., :n_pos], x[..., n_pos:]
        delta = ee_pos(q) - goal["ee_goal"]
        w_pos, w_vel = _ee_weights(k, w, goal)
        quad = (w_pos * delta * delta).sum(-1)
        if use_ee_vel:
            eev = (ee_jac(q) @ qd[..., None])[..., 0] - goal.get("ee_vel_goal", 0.0)
            quad = quad + (w_vel.to(eev.dtype) * eev * eev).sum(-1)
        return 0.5 * quad, delta, w_pos, w_vel

    def _limit_terms(x, u, w, level):
        """Sum of limit penalties (level 0) or their grad diag (1) / hess diag (2)."""
        pos_l, vel_l, tq_l = _limits(x)
        pq, dq_, d2q = _quad_pen(x[..., :n_pos], pos_l)
        pv, dv, d2v = _quad_pen(x[..., n_pos:], vel_l)
        pt, dt_, d2t = _quad_pen(u, tq_l)
        if level == 0:
            return w.q_pl * pq.sum(-1) + w.q_vl * pv.sum(-1) + w.r_tl * pt.sum(-1)
        if level == 1:
            return torch.cat([w.q_pl * dq_, w.q_vl * dv, w.r_tl * dt_], dim=-1)
        return torch.cat([w.q_pl * d2q, w.q_vl * d2v, w.r_tl * d2t], dim=-1)

    def _nominal_weights(k, w: CostWeights):
        terminal = k == nf
        return (_where(terminal, w.qf_xee, w.q_xee), _where(terminal, w.qf_xdee, w.q_xdee))

    def _rk(k, w):
        return _where(k == nf, 0.0, w.r_ee)

    def stage(x, u, k, goal, w: CostWeights):
        w = weights_of(w, x)
        ee_c, _, _, _ = _ee_terms(x, k, goal, w)
        if use_smooth_abs:
            a = smooth_abs_alpha
            ee_c = torch.sqrt(2.0 * ee_c + a * a) - a
        u_sq = (u * u).sum(-1)
        cost = ee_c + (0.5 * _rk(k, w)).to(u_sq.dtype) * u_sq
        qq, qqd = _nominal_weights(k, w)
        dxt = x - goal["x_target"]
        cost = cost + 0.5 * (
            qq * (dxt[..., :n_pos] ** 2).sum(-1) + qqd * (dxt[..., n_pos:] ** 2).sum(-1)
        )
        if use_limits:
            cost = cost + _limit_terms(x, u, w, 0)
        return cost

    def quad(x, u, k, goal, w: CostWeights):
        w = weights_of(w, x)
        q, qd = x[..., :n_pos], x[..., n_pos:]
        ee_c, delta, w_pos, w_vel = _ee_terms(x, k, goal, w)
        jac = ee_jac(q)                                           # (..., 6, n_pos)

        # gradient of the EE term w.r.t. x (cost_arm.cuh:224-254)
        g_ee_q = torch.einsum("...i,...ij->...j", w_pos * delta, jac)
        g_ee_qd = torch.zeros_like(q)
        if use_ee_vel:
            eev = (jac @ qd[..., None])[..., 0] - goal.get("ee_vel_goal", 0.0)
            dv_dq = deev_dq(q, qd)
            g_ee_q = g_ee_q + torch.einsum("...i,...ij->...j", w_vel * eev, dv_dq)
            g_ee_qd = torch.einsum("...i,...ij->...j", w_vel * eev, jac)
        g_ee_x = torch.cat([g_ee_q, g_ee_qd], dim=-1)
        if use_smooth_abs:
            a = smooth_abs_alpha
            g_ee_x = g_ee_x / torch.sqrt(2.0 * ee_c + a * a)[..., None]

        qq, qqd = _nominal_weights(k, w)
        dxt = x - goal["x_target"]
        g_nom = torch.cat([qq[..., None] * dxt[..., :n_pos],
                           qqd[..., None] * dxt[..., n_pos:]], dim=-1)
        rk = _rk(k, w)
        g = torch.cat([g_ee_x + g_nom, rk[..., None] * u], dim=-1)
        if use_limits:
            g = g + _limit_terms(x, u, w, 1)

        # Gauss-Newton Hessian: UNWEIGHTED J^T J in the q (or full-x with EE
        # vel) block (cost_arm.cuh:347-380 with `*factor` commented out)
        batch = x.shape[:-1]
        h = x.new_zeros(batch + (n_state + n_ctrl, n_state + n_ctrl))
        if use_ee_vel:
            top = torch.cat([jac, torch.zeros_like(jac)], dim=-1)
            bot = torch.cat([dv_dq, jac], dim=-1)
            jpv = torch.cat([top, bot], dim=-2)                   # (..., 12, n_state)
            h[..., :n_state, :n_state] = jpv.mT @ jpv
        else:
            h[..., :n_pos, :n_pos] = jac.mT @ jac
        diag_nom = torch.cat([qq[..., None].expand(batch + (n_pos,)),
                              qqd[..., None].expand(batch + (n_pos,)),
                              rk[..., None].expand(batch + (n_ctrl,))], dim=-1)
        h = h + torch.diag_embed(diag_nom)
        if use_limits:
            h = h + torch.diag_embed(_limit_terms(x, u, w, 2))
        return h, g

    return CostModel(name="ee_cost", stage=stage, quad=quad)


# Kuka iiwa-14 limits (cost_arm.cuh:12-25, safety factor 0.8 applied)
KUKA_POS_LIMITS = np.asarray(
    [2.96705972839, 2.09439510239, 2.96705972839, 2.09439510239, 2.96705972839,
     2.09439510239, 3.05432619099], np.float32
) * 0.8
KUKA_VEL_LIMITS = np.asarray(
    [1.483529, 1.483529, 1.745329, 1.308996, 2.268928, 2.356194, 2.356194],
    np.float32
) * 0.8
KUKA_TORQUE_LIMITS = np.full((7,), 300.0, np.float32) * 0.8
