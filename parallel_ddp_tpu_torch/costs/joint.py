"""Joint-space diagonal quadratic costs (twin of
`parallel_ddp_tpu/costs/joint.py`), evaluated over the time axis as a batch.

Covers the four reference plants' joint-level families:
  pendulum / cart-pole: QR(i) = Q1 if i == 0 else Q2 if i == 2 else R,
    terminal QF on the states (cost_pend.cuh:19-55, cost_cart.cuh);
  quadrotor: Q1 xyz / Q2 rpy / Q3 xyzdot / Q4 rpydot, R controls, QF
    terminal (cost_quad.cuh:19-58);
  Kuka arm joint mode: Q1 on q, Q2 on qd, R, terminal QF1 / QF2, runtime
    tunable (cost_arm.cuh:126-202): the `CostWeights` fields q1, q2, r,
    qf1, qf2, read as data (0-d tensors, `config.weights_of`).

cost = 0.5 * sum_i q_i(k) (x_i - xg_i)^2 + 0.5 * sum_j r_j u_j^2 (no control
cost at the terminal knot k = N-1).  Gradient and Hessian are the exact
diagonals.  The goal is the target state itself, a bare tensor (n_state,).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from parallel_ddp_tpu_torch.config import CostWeights, weights_of
from parallel_ddp_tpu_torch.costs.base import CostModel


def _make(name: str, num_time_steps: int, diags: Callable) -> CostModel:
    """diags(w, like) -> (q_diag, r_diag, qf_diag) weight vectors on like's
    device and dtype."""
    nf = num_time_steps - 1

    def weights_at(x, k, w):
        q_diag, r_diag, qf_diag = diags(w, x)
        terminal = (k == nf)[..., None]
        qk = torch.where(terminal, qf_diag, q_diag)
        rk = torch.where(terminal, torch.zeros_like(r_diag), r_diag)
        return qk, rk

    def stage(x, u, k, goal, w: CostWeights):
        qk, rk = weights_at(x, k, w)
        dx = x - goal
        return 0.5 * ((qk * dx * dx).sum(-1) + (rk * u * u).sum(-1))

    def quad(x, u, k, goal, w: CostWeights):
        qk, rk = weights_at(x, k, w)
        dx = x - goal
        batch = torch.broadcast_shapes(x.shape[:-1], qk.shape[:-1])
        qk = qk.expand(batch + qk.shape[-1:])
        rk = rk.expand(batch + rk.shape[-1:])
        g = torch.cat([qk * dx, rk * u], dim=-1)
        h = torch.diag_embed(torch.cat([qk, rk], dim=-1))
        return h, g

    return CostModel(name=name, stage=stage, quad=quad)


def fixed_diag_cost(name: str, num_time_steps: int, q_diag, r_diag, qf_diag) -> CostModel:
    """Cost with fixed (not runtime-tunable) diagonal float32 weights, made
    into tensors once per device and dtype: like's, but never below float32
    (the JAX package's numpy float32 weights, which keep a bfloat16 stage's
    products in float32)."""
    host = tuple(np.asarray(a, np.float32) for a in (q_diag, r_diag, qf_diag))
    cache = {}

    def diags(w, like):
        key = (like.device, torch.promote_types(like.dtype, torch.float32))
        if key not in cache:
            cache[key] = tuple(torch.as_tensor(a, dtype=key[1], device=like.device)
                               for a in host)
        return cache[key]

    return _make(name, num_time_steps, diags)


def pendulum_cost(num_time_steps: int) -> CostModel:
    """QR = [Q1, R] = [1.0, 0.1], R = 0.1, QF = 1000 (cost_pend.cuh:19-24)."""
    return fixed_diag_cost(
        "pendulum_joint", num_time_steps, [1.0, 0.1], [0.1], [1000.0, 1000.0]
    )


def cartpole_cost(num_time_steps: int) -> CostModel:
    """QR = [Q1, R, Q2, R] = [1.0, 0.1, 0.1, 0.1] (cost_cart.cuh QR macro)."""
    return fixed_diag_cost(
        "cartpole_joint", num_time_steps, [1.0, 0.1, 0.1, 0.1], [0.1], [1000.0] * 4
    )


def quadrotor_cost(num_time_steps: int) -> CostModel:
    """Q = [.01 xyz, .001 rpy, 2 xyzdot, 2 rpydot], R = 5, QF = 1000 (cost_quad.cuh:19-25)."""
    q = [0.01] * 3 + [0.001] * 3 + [2.0] * 3 + [2.0] * 3
    return fixed_diag_cost("quad_joint", num_time_steps, q, [5.0] * 4, [1000.0] * 12)


def joint_cost(name: str, num_time_steps: int, n_pos: int, n_ctrl: int) -> CostModel:
    """Runtime-tunable Q1/Q2/R/QF1/QF2 joint cost (arm joint mode,
    cost_arm.cuh:126-202): the weights are data, so a new value needs no new
    CUDA graph."""

    def diags(w, like):
        w = weights_of(w, like)
        q = torch.cat([w.q1.expand(n_pos), w.q2.expand(n_pos)])
        r = w.r.expand(n_ctrl)
        qf = torch.cat([w.qf1.expand(n_pos), w.qf2.expand(n_pos)])
        return q, r, qf

    return _make(name, num_time_steps, diags)
