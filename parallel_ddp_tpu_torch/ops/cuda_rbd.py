"""Batched Kuka RBD Jacobian: the CUDA kernel, its plain PyTorch version, and
the Butcher-stage composer that turns it into the discrete AB.

Twin of `parallel_ddp_tpu/ops/pallas_rbd.py`.  `kuka_jac_qdd(x, u)` returns
(d qdd / d [x; u] (B, 7, 21), qdd (B, 7)):
  * on CPU tensors, its plain version: `torch.func.jacfwd` of the torch soa
    dynamics, vmapped over the batch, plus the primal;
  * on CUDA tensors, the hand-written kernel `csrc/rbd_jac.cu` (forward mode
    by dual numbers, one thread per (sample, tangent column)), or it raises.

`make_kuka_ab` composes it into AB = [A | B] over the whole time axis — the
solver's derivative stage on the main path (`Plant.batched_step_jac`).
"""

from __future__ import annotations

import functools

import torch

from parallel_ddp_tpu_torch.models.kuka import soa
from parallel_ddp_tpu_torch.ops import build

N_JOINTS = 7
_NX = 2 * N_JOINTS
_NIN = 3 * N_JOINTS


@functools.lru_cache(maxsize=16)
def consts_tensor(ee_type: int, gravity: float, device: str) -> torch.Tensor:
    """The chain constants as the float32 device array the kernels read
    (`csrc/kuka_soa.cuh`), cached per device."""
    return torch.as_tensor(soa._consts(ee_type, float(gravity)).flat(),
                           device=torch.device(device))


def kuka_jac_qdd_plain(x, u, ee_type: int = 1, gravity: float = 9.81):
    """Plain version: (jacfwd of the soa qdd (B, 7, 21), primal qdd (B, 7))."""
    dyn = soa.KukaSoA(ee_type=ee_type, gravity=gravity).forward_dynamics

    def f(xs, us):
        out = dyn(xs, us)
        return out, out

    (jx, ju), qdd = torch.func.vmap(
        torch.func.jacfwd(f, argnums=(0, 1), has_aux=True))(x, u)
    return torch.cat([jx, ju], dim=-1), qdd


def kuka_jac_qdd_cuda(x, u, ee_type: int = 1, gravity: float = 9.81):
    """Launch the RBD-Jacobian kernel on CUDA tensors x (B, 14), u (B, 7)."""
    B = x.shape[0]
    build.check_input("x", x, (B, _NX))
    build.check_input("u", u, (B, N_JOINTS))
    if u.device != x.device:
        raise ValueError(f"x on {x.device} but u on {u.device}")
    jac = torch.empty((B, N_JOINTS, _NIN), device=x.device, dtype=torch.float32)
    qdd = torch.empty((B, N_JOINTS), device=x.device, dtype=torch.float32)
    cc = consts_tensor(ee_type, float(gravity), str(x.device))
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = lib.pddp_rbd_jac(cc.data_ptr(), x.data_ptr(), u.data_ptr(),
                                  jac.data_ptr(), qdd.data_ptr(), B, stream)
    build.check(status, "rbd_jac")
    kuka_jac_qdd_cuda.launches += 1
    return jac, qdd


kuka_jac_qdd_cuda.launches = 0


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


def make_kuka_ab(ee_type: int, gravity: float, integrator: int, dt: float):
    """Batched discrete-dynamics Jacobian AB = [A | B] through the RBD-Jacobian
    op: ab(x (B, 14), u (B, 7)) -> (B, 14, 21), one op call per Butcher stage
    over the whole batch, chained by `make_ab_composer` (the solver's
    derivative stage, integratorGradientKern)."""
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
