"""Quadrotor (twin of `parallel_ddp_tpu/models/quadrotor.py`): the 12-state,
4-rotor Newton-Euler model of dynamics_quad.cuh:40-65.

State x = [x, y, z, roll, pitch, yaw, xd, yd, zd, rolld, pitchd, yawd]; u = four
rotor thrusts; any leading batch dims.  Parameters (dynamics_quad.cuh:13-31):
m = 0.5, L = 0.175, Ixx = Iyy = 0.0023, Izz = 0.004, g = -9.81, yaw moment
coefficient km = 0.0245.

The same compact physical form as the JAX package: translational
accelerations from the total thrust through the ZYX body rotation; Euler-angle
accelerations from the rigid-body Euler equations in the body frame, mapped
back through the angular-velocity kinematics omega = W(roll, pitch) eul_d:

    eul_dd = W^-1 (omega_dot - dW/dt eul_d).

The JAX package solves that 3x3 system by LU (`jnp.linalg.solve`).  Here
W^-1 is written in closed form (det W = cos(pitch), the model's own gimbal
singularity): every operation is elementwise, so the step has no host sync
(`torch.linalg.solve` checks its pivots on the host, which a CUDA graph
cannot capture) and `torch.func.jacfwd` differentiates it.  The two differ
by float32 rounding only (`tests/test_torch_plants.py` states the bound).
"""

from __future__ import annotations

import torch

from parallel_ddp_tpu_torch.models.base import Plant

GRAVITY = -9.81
MASS = 0.5
LENGTH = 0.175
IXX = 0.0023
IYY = 0.0023
IZZ = 0.004
KM = 0.0245  # yaw moment coefficient (dynamics_quad.cuh:61)


def _dynamics(x, u):
    # scalar channels keep a trailing axis of 1: under torch.func.jacfwd a
    # 0-d tensor combined with a Python number gets a float64 tangent
    roll, pitch, yaw = x[..., 3:4], x[..., 4:5], x[..., 5:6]
    rolld, pitchd, yawd = x[..., 9:10], x[..., 10:11], x[..., 11:12]
    u0, u1, u2, u3 = u[..., 0:1], u[..., 1:2], u[..., 2:3], u[..., 3:4]
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)

    thrust = u.sum(-1, keepdim=True)
    # translational: R_wb @ [0, 0, thrust] / m + g (dynamics_quad.cuh:55-57)
    acc = [thrust / MASS * (sr * sy + cr * cy * sp),
           -thrust / MASS * (cy * sr - cr * sp * sy),
           GRAVITY + thrust / MASS * cr * cp]

    # body rates omega = W eul_d, W = [[1, 0, -sp], [0, cr, sr cp], [0, -sr, cr cp]]
    w0 = rolld - sp * yawd
    w1 = cr * pitchd + (sr * cp) * yawd
    w2 = (cr * cp) * yawd - sr * pitchd
    # Euler's equations: omega_dot = (tau - omega x (I omega)) / I
    iw0, iw1, iw2 = IXX * w0, IYY * w1, IZZ * w2
    tau0 = LENGTH * (u1 - u3)
    tau1 = LENGTH * (u2 - u0)
    tau2 = KM * (u0 - u1 + u2 - u3)
    wd0 = (tau0 - (w1 * iw2 - w2 * iw1)) / IXX
    wd1 = (tau1 - (w2 * iw0 - w0 * iw2)) / IYY
    wd2 = (tau2 - (w0 * iw1 - w1 * iw0)) / IZZ

    # r = omega_dot - dW/dt eul_d
    r0 = wd0 - (-cp * pitchd) * yawd
    r1 = wd1 - ((-sr * rolld) * pitchd + (cr * cp * rolld - sr * sp * pitchd) * yawd)
    r2 = wd2 - ((-cr * rolld) * pitchd + (-sr * cp * rolld - cr * sp * pitchd) * yawd)

    # eul_dd = W^-1 r, W^-1 = [[1, sr sp/cp, cr sp/cp], [0, cr, -sr], [0, sr/cp, cr/cp]]
    yaw_dd = (sr * r1 + cr * r2) / cp
    return torch.cat(acc + [r0 + sp * yaw_dd, cr * r1 - sr * r2, yaw_dd], dim=-1)


def quadrotor() -> Plant:
    return Plant(
        name="quadrotor",
        n_pos=6,
        n_ctrl=4,
        dynamics=_dynamics,
        rho_init_default=1.0,
        max_defect_default=1.0,
        alpha_base_default=0.5,
        num_alpha_default=16,
    )
