"""Explicit integrators and their discrete Jacobians (twin of
`parallel_ddp_tpu/ops/integrators.py`; utils/integrators.cuh:14-236).

Each integrator maps (x_k, u_k) -> x_{k+1} using the plant's continuous
dynamics qdd = f(x, u) with x = [q; qd] and xd = [qd; qdd].  The step
functions take any leading batch dims.  The discrete Jacobian
AB = d x_{k+1} / d [x_k; u_k] is `torch.func.jacfwd` of one step, evaluated at
the exact stage points:
  Euler    : x' = x + dt*[qd; f(x,u)]
  Midpoint : k1 at x; xm = x + dt/2*k1; x' = x + dt*k2
  RK3      : k1 at x; x2 = x + dt/2*k1; k2 at x2;
             x3 = x + dt*(2*k2 - k1); k3 at x3; x' = x + dt/6*(k1 + 4*k2 + k3)
"""

from __future__ import annotations

from typing import Callable

import torch

from parallel_ddp_tpu_torch.models.base import Plant


def _xdot(plant: Plant, x, u):
    qd = x[..., plant.n_pos:]
    qdd = plant.dynamics(x, u)
    return torch.cat([qd, qdd], dim=-1)


def make_step(plant: Plant, integrator: int, dt: float) -> Callable:
    """Return step(x, u) -> x_next for the chosen integrator (1/2/3)."""

    if integrator == 1:

        def step(x, u):
            return x + dt * _xdot(plant, x, u)

    elif integrator == 2:

        def step(x, u):
            k1 = _xdot(plant, x, u)
            xm = x + 0.5 * dt * k1
            k2 = _xdot(plant, xm, u)
            return x + dt * k2

    elif integrator == 3:

        def step(x, u):
            k1 = _xdot(plant, x, u)
            x2 = x + 0.5 * dt * k1
            k2 = _xdot(plant, x2, u)
            x3 = x + dt * (2.0 * k2 - k1)
            k3 = _xdot(plant, x3, u)
            return x + (dt / 6.0) * (k1 + 4.0 * k2 + k3)

    else:
        raise ValueError(f"unknown integrator {integrator}")

    return step


def make_step_jacobian(plant: Plant, integrator: int, dt: float) -> Callable:
    """Return jac(x, u) -> AB (n_state, n_state + n_ctrl) for one sample, the
    discrete dynamics Jacobian [A | B] (`_integratorGradient`)."""

    step = make_step(plant, integrator, dt)

    def jac(x, u):
        a, b = torch.func.jacfwd(step, argnums=(0, 1))(x, u)
        return torch.cat([a, b], dim=1)

    return jac
