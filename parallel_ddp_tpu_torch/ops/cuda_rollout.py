"""Fused multiple-shooting rollout: the CUDA kernel and its plain version.

Twin of `parallel_ddp_tpu/ops/pallas_rollout.py`.  The factory
`make_kuka_fused_rollout` returns

    fused(x_swept (A,N,n), u (N,m), K (N,m,n), du (N,m), xp (N,n),
          alphas (A,), skip_mask=None) -> (x_next_all (A,M,Nf,n),
                                            u_new_all (A,M,Nf,m))

the whole forward simulation of every (alpha, shooting block) lane:
  * on CPU tensors, the plain version `rollout_plain` — the loop of
    `parallel/forward.py::make_sim_block`, batched over the lanes;
  * on CUDA tensors, the kernel `csrc/rollout.cu` (one thread per lane, a
    serial loop over the block's steps), or it raises.

`skip_mask` (M, Nf) marks steps that are not simulated; it defaults to the
horizon's last step k = N-1 (fpHelpers.cuh:235).
"""

from __future__ import annotations

import functools

import torch

from parallel_ddp_tpu_torch.models.base import Plant
from parallel_ddp_tpu_torch.models.kuka import soa
from parallel_ddp_tpu_torch.ops import build
from parallel_ddp_tpu_torch.ops.cuda_rbd import consts_tensor
from parallel_ddp_tpu_torch.ops.integrators import make_step

NJ = 7
NS = 14


def rollout_plain(step_fn, x0, u_b, K_b, du_b, xp_b, alpha, skip):
    """Closed-loop rollout of shooting blocks (forwardSimInner,
    fpHelpers.cuh:223-275), batched over any broadcastable leading dims:

      x0 (..., n), u_b (..., Nf, m), K_b (..., Nf, m, n), du_b (..., Nf, m),
      xp_b (..., Nf, n), alpha (...,), skip (..., Nf) bool
      -> (x_next (..., Nf, n), u_new (..., Nf, m))

    Per step: u_new = u - alpha*du - K (x - xp), then one integrator step; a
    skipped step keeps u and holds x."""
    x = x0
    xs, us = [], []
    for t in range(u_b.shape[-2]):
        u_k = u_b[..., t, :]
        fb = (K_b[..., t, :, :] @ (x - xp_b[..., t, :])[..., None])[..., 0]
        u_new = u_k - alpha[..., None] * du_b[..., t, :] - fb
        s = skip[..., t, None]
        u_new = torch.where(s, u_k, u_new)
        x_next = torch.where(s, x, step_fn(x, u_new))
        xs.append(x_next)
        us.append(u_new)
        x = x_next
    return torch.stack(xs, dim=-2), torch.stack(us, dim=-2)


@functools.lru_cache(maxsize=16)
def _kuka_step(ee_type: int, gravity: float, integrator: int, dt: float):
    plant = Plant(name="kuka_soa", n_pos=NJ, n_ctrl=NJ,
                  dynamics=soa.KukaSoA(ee_type=ee_type, gravity=gravity).forward_dynamics)
    return make_step(plant, integrator, dt)


def kuka_rollout_plain(x_swept, u, K, du, xp, alphas, skip, *, ee_type: int,
                       gravity: float, integrator: int, dt: float, m_blocks: int):
    """Plain version of `kuka_rollout_cuda` (same arguments and outputs): the
    `rollout_plain` loop over the lanes with the soa integrator step."""
    A, N = x_swept.shape[0], x_swept.shape[1]
    M = m_blocks
    nf = N // M
    return rollout_plain(
        _kuka_step(ee_type, float(gravity), integrator, dt),
        x_swept.reshape(A, M, nf, NS)[:, :, 0], u.reshape(M, nf, NJ),
        K.reshape(M, nf, NJ, NS), du.reshape(M, nf, NJ), xp.reshape(M, nf, NS),
        alphas.to(x_swept.dtype)[:, None], skip.to(torch.bool))


def kuka_rollout_cuda(x_swept, u, K, du, xp, alphas, skip, *, ee_type: int,
                      gravity: float, integrator: int, dt: float, m_blocks: int):
    """Launch the rollout kernel.  skip is (M, Nf) uint8; the rest float32."""
    A, N = x_swept.shape[0], x_swept.shape[1]
    M = m_blocks
    if N % M:
        raise ValueError(f"horizon {N} not divisible into {M} shooting blocks")
    nf = N // M
    build.check_input("x_swept", x_swept, (A, N, NS))
    build.check_input("u", u, (N, NJ))
    build.check_input("K", K, (N, NJ, NS))
    build.check_input("du", du, (N, NJ))
    build.check_input("xp", xp, (N, NS))
    build.check_input("alphas", alphas, (A,))
    build.check_input("skip", skip, (M, nf), torch.uint8)
    for t in (u, K, du, xp, alphas, skip):
        if t.device != x_swept.device:
            raise ValueError("all rollout inputs must be on one device")
    if integrator not in (1, 2, 3):
        raise ValueError(f"unknown integrator {integrator}")
    xout = torch.empty((A, M, nf, NS), device=x_swept.device, dtype=torch.float32)
    uout = torch.empty((A, M, nf, NJ), device=x_swept.device, dtype=torch.float32)
    cc = consts_tensor(ee_type, float(gravity), str(x_swept.device))
    lib = build.library()
    with torch.cuda.device(x_swept.device):
        stream = torch.cuda.current_stream(x_swept.device).cuda_stream
        status = lib.pddp_rollout(
            cc.data_ptr(), x_swept.data_ptr(), u.data_ptr(), K.data_ptr(),
            du.data_ptr(), xp.data_ptr(), alphas.data_ptr(), skip.data_ptr(),
            xout.data_ptr(), uout.data_ptr(), A, M, nf, integrator,
            dt, 0.5 * dt, dt / 6.0, stream)
    build.check(status, "rollout")
    kuka_rollout_cuda.launches += 1
    return xout, uout


kuka_rollout_cuda.launches = 0


def make_kuka_fused_rollout(ee_type: int, gravity: float, integrator: int,
                            dt: float, num_time_steps: int, m_blocks_f: int,
                            num_alpha: int):
    """Factory for the solver hook (`Plant.fused_rollout`); see the module
    docstring for the contract.  Raises if the horizon does not split into
    `m_blocks_f` equal blocks."""
    N, M = num_time_steps, m_blocks_f
    if N % M:
        raise ValueError(f"num_time_steps {N} not divisible by m_blocks_f {M}")
    nf = N // M
    default_skip = {}

    def _default_skip(device):
        if device not in default_skip:          # only k = N-1 is skipped
            k = torch.arange(N, device=device).reshape(M, nf)
            default_skip[device] = k == N - 1
        return default_skip[device]

    def fused(x_swept, u, K, du, xp, alphas, skip_mask=None):
        A = alphas.shape[0]
        if A != num_alpha:
            raise ValueError(f"expected {num_alpha} alphas, got {A}")
        dev = x_swept.device
        skip = _default_skip(dev) if skip_mask is None else skip_mask.to(dev, torch.bool)
        kw = dict(ee_type=ee_type, gravity=gravity, integrator=integrator, dt=dt,
                  m_blocks=M)
        if dev.type == "cpu":
            return kuka_rollout_plain(x_swept, u, K, du, xp, alphas, skip, **kw)
        return kuka_rollout_cuda(
            x_swept.contiguous(), u.contiguous(), K.contiguous(),
            du.contiguous(), xp.contiguous(), alphas.contiguous(),
            skip.to(torch.uint8).contiguous(), **kw)

    return fused
