"""Cart-pole (twin of `parallel_ddp_tpu/models/cartpole.py`): the 2-DoF
analytic mass-matrix solve of dynamics_cart.cuh:28-43.

State x = [cart position, pole angle, cart vel, pole angular vel], control =
cart force; any leading batch dims.  Parameters: m_cart = 10, m_pole = 1,
l_pole = 0.5, g = -9.81 (dynamics_cart.cuh:13-19).
"""

from __future__ import annotations

import torch

from parallel_ddp_tpu_torch.models.base import Plant

GRAVITY = -9.81
M_CART = 10.0
M_POLE = 1.0
L_POLE = 0.5
ML = M_POLE * L_POLE
MLL = ML * L_POLE


def _dynamics(x, u):
    # scalar channels keep a trailing axis of 1: under torch.func.jacfwd a
    # 0-d tensor combined with a Python number gets a float64 tangent
    theta, thetad = x[..., 1:2], x[..., 3:4]
    ct, st = torch.cos(theta), torch.sin(theta)
    h0 = M_CART + M_POLE
    h1 = MLL
    hod = ML * ct
    tau_m = ML * st
    tau0 = tau_m * thetad * thetad + u[..., :1]
    tau1 = tau_m * GRAVITY
    det = 1.0 / (h0 * h1 - hod * hod)
    return torch.cat([det * (h1 * tau0 - hod * tau1), det * (h0 * tau1 - hod * tau0)], dim=-1)


def cartpole() -> Plant:
    return Plant(
        name="cartpole",
        n_pos=2,
        n_ctrl=1,
        dynamics=_dynamics,
        rho_init_default=10.0,
        max_defect_default=0.75,
        alpha_base_default=0.75,
        num_alpha_default=32,
    )
