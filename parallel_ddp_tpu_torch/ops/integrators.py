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
`make_step_jacobian_fd` is the central-difference alternative
(`SolverConfig.use_finite_diff`).
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


def make_bf16_step(step: Callable) -> Callable:
    """The step in bfloat16 (`SolverConfig.bf16_rollout`; the JAX package's
    `step_fn_fwd`): x and u cast to bfloat16, every integrator stage and the
    dynamics computed on them (a Python constant, dt among them, keeps a
    bfloat16 tensor bfloat16), x handed back in x's own dtype."""

    def bf16_step(x, u):
        return step(x.to(torch.bfloat16), u.to(torch.bfloat16)).to(x.dtype)

    return bf16_step


def make_step_jacobian(plant: Plant, integrator: int, dt: float) -> Callable:
    """Return jac(x, u) -> AB (n_state, n_state + n_ctrl) for one sample, the
    discrete dynamics Jacobian [A | B] (`_integratorGradient`)."""

    step = make_step(plant, integrator, dt)

    def jac(x, u):
        a, b = torch.func.jacfwd(step, argnums=(0, 1))(x, u)
        return torch.cat([a, b], dim=1)

    return jac


def make_step_jacobian_fd(plant: Plant, integrator: int, dt: float,
                          eps: float = 1e-4) -> Callable:
    """Central-finite-difference AB (the reference's USE_FINITE_DIFF variant,
    `finiteDiffInner`, nisInitHelpers.cuh:138-243), batched: returns
    jac(xs (S, n_state), us (S, n_ctrl)) -> AB (S, n_state, n_state + n_ctrl),
    marked `_is_batched` so the solver's derivative stage calls it on the
    whole time axis at once.

    The 2 (n + m) perturbed copies of every sample, +eps and then -eps on
    each input in turn, are stacked on a leading axis and stepped by ONE
    call of the step, so a plant whose dynamics is a kernel (the Kuka "cuda"
    core's `kuka_qdd`) launches it once per integrator stage for the whole
    horizon.  Column i is (step(z + eps e_i) - step(z - eps e_i)) / (2 eps),
    the JAX package's formula term for term."""
    step = make_step(plant, integrator, dt)
    n, m = plant.n_state, plant.n_ctrl
    cache = {}

    def jac(xs, us):
        key = (xs.device, xs.dtype)
        if key not in cache:
            cache[key] = torch.eye(n + m, dtype=xs.dtype, device=xs.device) * eps
        delta = cache[key]                                          # (n+m, n+m)
        xu = torch.cat([xs, us], dim=-1)                            # (S, n+m)
        z = torch.cat([xu + delta[:, None, :], xu - delta[:, None, :]])   # (2(n+m), S, n+m)
        out = step(z[..., :n], z[..., n:])                          # (2(n+m), S, n)
        return ((out[:n + m] - out[n + m:]) / (2.0 * eps)).permute(1, 2, 0)

    jac._is_batched = True
    return jac
