"""Batched Kuka rigid-body dynamics: forward dynamics and its Jacobian, each a
CUDA kernel with its plain PyTorch version, and the Butcher-stage composer
that turns the Jacobian into the discrete AB.

Twin of `parallel_ddp_tpu/ops/pallas_rbd.py`.  `kuka_qdd(x, u)` returns qdd
(..., 7) for any leading dims:
  * on CPU tensors, its plain version: the torch soa `forward_dynamics`;
  * on CUDA tensors, the hand-written kernel `csrc/qdd.cu` (one thread per
    sample), or it raises.  The kernel has no backward (`kuka_jac_qdd` is
    its derivative): under autograd or a `torch.func` transform it raises.
`Plant.dynamics` of the "cuda" core is `kuka_qdd`: batched single evaluations
of the dynamics launch it.  Chains of dependent integrator steps (cold
rollout, MPC warm start, plant substeps) go through `ops/cuda_sim_chain.py`,
whose kernel runs the time loop inside one launch.

`kuka_jac_qdd(x, u)` returns
(d qdd / d [x; u] (B, 7, 21), qdd (B, 7)):
  * on CPU tensors, its plain version: forward-mode AD of the torch soa
    dynamics (`torch.autograd.forward_ad`, the 21 unit tangents as a batch
    dimension), plus the primal;
  * on CUDA tensors, the hand-written kernel `csrc/rbd_jac.cu` (forward mode
    by dual numbers, a group of threads per (sample, tangent column), one in
    each warp of a thread block), or it raises.
`kuka_euler_ab(x, u, dt)` returns the Euler step's AB = E + dt [[0 I 0]; [J]]
(B, 14, 21): on CUDA tensors the same kernel writes it in its epilogue (one
launch, nothing else); on CPU tensors the composer on the plain Jacobian.

`make_kuka_ab` composes the Jacobian into AB = [A | B] over the whole time
axis — the solver's derivative stage on the main path
(`Plant.batched_step_jac`).
"""

from __future__ import annotations

import functools

import torch
import torch.autograd.forward_ad as fwad

from parallel_ddp_tpu_torch.models.kuka import soa
from parallel_ddp_tpu_torch.ops import build

N_JOINTS = 7
_NX = 2 * N_JOINTS
_NIN = 3 * N_JOINTS


@functools.lru_cache(maxsize=16)
def consts_tensor(ee_type: int, gravity: float, device: torch.device) -> torch.Tensor:
    """The chain constants as the float32 device array the kernels read
    (`csrc/kuka_soa.cuh`), cached per device."""
    return torch.as_tensor(soa._consts(ee_type, float(gravity)).flat(), device=device)


def kuka_qdd_plain(x, u, ee_type: int = 1, gravity: float = 9.81):
    """Plain version: the soa forward dynamics, qdd (..., 7)."""
    return soa.KukaSoA(ee_type=ee_type, gravity=gravity).forward_dynamics(x, u)


def kuka_qdd_cuda(x, u, ee_type: int = 1, gravity: float = 9.81):
    """Launch the forward-dynamics kernel on CUDA tensors x (..., 14),
    u (..., 7) with the same leading dims; returns qdd (..., 7)."""
    if torch._C._functorch.is_functorch_wrapped_tensor(x) or \
            torch._C._functorch.is_functorch_wrapped_tensor(u):
        raise RuntimeError("kuka_qdd_cuda has no torch.func rule; "
                           "differentiate through kuka_jac_qdd instead")
    if torch.is_grad_enabled() and (x.requires_grad or u.requires_grad):
        raise RuntimeError("kuka_qdd_cuda has no backward; use kuka_jac_qdd")
    lead = x.shape[:-1]
    if u.shape[:-1] != lead:
        raise ValueError(f"x {tuple(x.shape)} and u {tuple(u.shape)} differ in leading dims")
    xf = x.reshape(-1, _NX).contiguous()
    uf = u.reshape(-1, N_JOINTS).contiguous()
    B = xf.shape[0]
    build.check_input("x", xf, (B, _NX))
    build.check_input("u", uf, (B, N_JOINTS))
    if uf.device != xf.device:
        raise ValueError(f"x on {x.device} but u on {u.device}")
    qdd = torch.empty((B, N_JOINTS), device=x.device, dtype=torch.float32)
    cc = consts_tensor(ee_type, float(gravity), x.device)
    build.launch("pddp_qdd", x.device, cc.data_ptr(), xf.data_ptr(), uf.data_ptr(),
                 qdd.data_ptr(), B)
    kuka_qdd_cuda.counter.hit(x.device)
    return qdd.reshape(lead + (N_JOINTS,))


kuka_qdd_cuda.counter = build.launch_counter("qdd")


def kuka_qdd(x, u, ee_type: int = 1, gravity: float = 9.81):
    """Forward dynamics qdd (..., 7) of the Kuka arm: the plain version on
    CPU tensors, the CUDA kernel on CUDA tensors."""
    if x.device.type == "cpu" and u.device.type == "cpu":
        return kuka_qdd_plain(x, u, ee_type, gravity)
    return kuka_qdd_cuda(x, u, ee_type, gravity)


def kuka_jac_qdd_plain(x, u, ee_type: int = 1, gravity: float = 9.81):
    """Plain version: (the soa qdd's Jacobian (B, 7, 21), primal qdd (B, 7)),
    by forward-mode AD with tangent j of the 21 inputs on leading index j
    (the same rules as `torch.func.jacfwd`, without its vmap levels)."""
    dyn = soa.KukaSoA(ee_type=ee_type, gravity=gravity).forward_dynamics
    B = x.shape[0]
    xu = torch.cat([x, u], dim=-1)[None].expand(_NIN, B, _NIN).contiguous()
    eye = torch.eye(_NIN, dtype=x.dtype, device=x.device)
    tangents = eye[:, None, :].expand(_NIN, B, _NIN).contiguous()
    with fwad.dual_level():
        dual = fwad.make_dual(xu, tangents)
        qdd, jac = fwad.unpack_dual(dyn(dual[..., :_NX], dual[..., _NX:]))
    return jac.permute(1, 2, 0), qdd[0]


def _launch_rbd_jac(x, u, ee_type, gravity, jac, qdd, ab, dt):
    """Check the inputs and launch the RBD-Jacobian kernel into the outputs
    given (None: that output is left out); counts the launch."""
    B = x.shape[0]
    build.check_input("x", x, (B, _NX))
    build.check_input("u", u, (B, N_JOINTS))
    if u.device != x.device:
        raise ValueError(f"x on {x.device} but u on {u.device}")
    cc = consts_tensor(ee_type, float(gravity), x.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    build.launch("pddp_rbd_jac", x.device, cc.data_ptr(), x.data_ptr(), u.data_ptr(),
                 ptr(jac), ptr(qdd), ptr(ab), B, dt)
    kuka_jac_qdd_cuda.counter.hit(x.device)


def kuka_jac_qdd_cuda(x, u, ee_type: int = 1, gravity: float = 9.81):
    """Launch the RBD-Jacobian kernel on CUDA tensors x (B, 14), u (B, 7)."""
    B = x.shape[0]
    jac = torch.empty((B, N_JOINTS, _NIN), device=x.device, dtype=torch.float32)
    qdd = torch.empty((B, N_JOINTS), device=x.device, dtype=torch.float32)
    _launch_rbd_jac(x, u, ee_type, gravity, jac, qdd, None, 0.0)
    return jac, qdd


# launches of the kernel, by either wrapper
kuka_jac_qdd_cuda.counter = build.launch_counter("rbd_jac")


def kuka_euler_ab_cuda(x, u, dt: float, ee_type: int = 1, gravity: float = 9.81):
    """Launch the RBD-Jacobian kernel on CUDA tensors x (B, 14), u (B, 7) for
    its Euler epilogue alone: AB = E + dt [[0 I 0]; [J]] (B, 14, 21)."""
    ab = torch.empty((x.shape[0], _NX, _NIN), device=x.device, dtype=torch.float32)
    _launch_rbd_jac(x, u, ee_type, gravity, None, None, ab, dt)
    return ab


def kuka_euler_ab_plain(x, u, dt: float, ee_type: int = 1, gravity: float = 9.81):
    """Plain version of `kuka_euler_ab_cuda`: the composer's E + dt * F on the
    plain Jacobian."""
    return _kuka_composed_ab(ee_type, float(gravity), 1, dt)(x, u)


def kuka_euler_ab(x, u, dt: float, ee_type: int = 1, gravity: float = 9.81):
    """The Euler step's AB (B, 14, 21): the plain version on CPU tensors, the
    CUDA kernel's epilogue on CUDA tensors."""
    if x.device.type == "cpu" and u.device.type == "cpu":
        return kuka_euler_ab_plain(x, u, dt, ee_type, gravity)
    return kuka_euler_ab_cuda(x.contiguous(), u.contiguous(), dt, ee_type, gravity)


def kuka_jac_qdd(x, u, ee_type: int = 1, gravity: float = 9.81):
    """Batched (jacobian (B, 7, 21), primal qdd (B, 7)) of the Kuka dynamics:
    the plain version on CPU tensors, the CUDA kernel on CUDA tensors."""
    if x.device.type == "cpu" and u.device.type == "cpu":
        return kuka_jac_qdd_plain(x, u, ee_type, gravity)
    return kuka_jac_qdd_cuda(x, u, ee_type, gravity)


def make_ab_composer(fdyn, fjac, integrator: int, dt: float, ns: int, nj: int,
                     fboth=None):
    """Compose batched stage dynamics/Jacobians into the discrete AB = [A | B].

    Generic Butcher-stage chain rule (integrators.cuh:40-233), independent of
    what produces the stage values:
      fdyn(x (B, ns), u (B, nj)) -> xdot (B, ns)
      fjac(x, u) -> d xdot / d [x; u] (B, ns, ns + nj)
      fboth (optional): (x, u) -> (xdot, F) from one evaluation.
    """
    if fboth is None:
        def fboth(x, u):
            return fdyn(x, u), fjac(x, u)

    def consts(x):
        eye_s = torch.eye(ns, dtype=x.dtype, device=x.device)
        eye_j = torch.eye(nj, dtype=x.dtype, device=x.device)
        E = torch.cat([eye_s, torch.zeros((ns, nj), dtype=x.dtype, device=x.device)], dim=1)
        U = torch.cat([torch.zeros((nj, ns), dtype=x.dtype, device=x.device), eye_j], dim=1)
        return E, U

    def chain(F, Dx, U):
        # d f(xs, u) / d [x; u] = F_x @ (d xs / d [x; u]) + F_u @ (d u / d [x; u])
        return torch.einsum("bij,bjk->bik", F[:, :, :ns], Dx) + F[:, :, ns:] @ U

    def ab(x, u):
        E, U = consts(x)
        if integrator == 1:  # Euler (integrators.cuh:40-53)
            return E + dt * fjac(x, u)
        if integrator == 2:  # Midpoint (integrators.cuh:84-120)
            k1, Dk1 = fboth(x, u)
            xm = x + (0.5 * dt) * k1
            Dk2 = chain(fjac(xm, u), E + (0.5 * dt) * Dk1, U)
            return E + dt * Dk2
        if integrator == 3:  # RK3 (integrators.cuh:159-233, exact stage points)
            k1, Dk1 = fboth(x, u)
            x2 = x + (0.5 * dt) * k1
            k2, F2 = fboth(x2, u)
            Dk2 = chain(F2, E + (0.5 * dt) * Dk1, U)
            x3 = x + dt * (2.0 * k2 - k1)
            Dk3 = chain(fjac(x3, u), E + dt * (2.0 * Dk2 - Dk1), U)
            return E + (dt / 6.0) * (Dk1 + 4.0 * Dk2 + Dk3)
        raise ValueError(f"unknown integrator {integrator}")

    return ab


@functools.lru_cache(maxsize=16)
def _kuka_composed_ab(ee_type: int, gravity: float, integrator: int, dt: float):
    """AB through the RBD-Jacobian op (`kuka_jac_qdd`), one op call per
    Butcher stage over the whole batch, chained by `make_ab_composer`."""
    ns, nj = _NX, N_JOINTS

    def _lift_jac(J):
        # F = d xdot / d [x; u]: rows [qd; qdd] -> [[0 I 0]; [J_qdd]], (B, 14, 21)
        top = torch.zeros((J.shape[0], nj, ns + nj), dtype=J.dtype, device=J.device)
        top[:, :, nj:ns] = torch.eye(nj, dtype=J.dtype, device=J.device)
        return torch.cat([top, J], dim=1)

    def fboth(x, u):
        J, qdd = kuka_jac_qdd(x.contiguous(), u.contiguous(), ee_type, gravity)
        return torch.cat([x[:, nj:], qdd], dim=1), _lift_jac(J)

    def fjac(x, u):
        return fboth(x, u)[1]

    # fdyn is unused when fboth is given: every stage needing the primal gets
    # it from the Jacobian kernel
    return make_ab_composer(None, fjac, integrator, dt, ns, nj, fboth=fboth)


def make_kuka_ab(ee_type: int, gravity: float, integrator: int, dt: float):
    """Batched discrete-dynamics Jacobian AB = [A | B]: ab(x (B, 14), u (B, 7))
    -> (B, 14, 21) (the solver's derivative stage, integratorGradientKern).
    Euler: `kuka_euler_ab` (on the card one kernel launch, the AB written in
    its epilogue).  Midpoint and RK3: the Jacobian op once per Butcher stage,
    chained by `make_ab_composer`."""
    if integrator != 1:
        return _kuka_composed_ab(ee_type, gravity, integrator, dt)

    def ab(x, u):
        return kuka_euler_ab(x, u, dt, ee_type, gravity)

    return ab
