"""Simple pendulum (twin of `parallel_ddp_tpu/models/pendulum.py`):
qdd = u + g*sin(q) (dynamics_pend.cuh:28-38, g = -9.81).  State [q, qd],
one control; any leading batch dims."""

from __future__ import annotations

import torch

from parallel_ddp_tpu_torch.models.base import Plant

GRAVITY = -9.81


def _dynamics(x, u):
    return u + GRAVITY * torch.sin(x[..., :1])


def pendulum() -> Plant:
    return Plant(
        name="pendulum",
        n_pos=1,
        n_ctrl=1,
        dynamics=_dynamics,
        rho_init_default=10.0,
        max_defect_default=1.0,
        alpha_base_default=0.75,
        num_alpha_default=32,
    )
