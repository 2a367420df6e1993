"""Fused multiple-shooting rollout: the CUDA kernel and its plain version.

Twin of `parallel_ddp_tpu/ops/pallas_rollout.py`.  The factory
`make_kuka_fused_rollout` returns

    fused(x_swept (...,A,N,n), u (...,N,m), K (...,N,m,n), du (...,N,m),
          xp (...,N,n), alphas (A,), skip_mask=None)
      -> (x_next_all (...,A,M,Nf,n), u_new_all (...,A,M,Nf,m))

the whole forward simulation of every (alpha, shooting block) lane, for one
problem or, with leading scenario dims "...", a batch of independent ones
that share the alphas and the skip mask:
  * on CPU tensors, the plain version `rollout_plain` — the loop of
    `parallel/forward.py::make_sim_block`, batched over the lanes;
  * on CUDA tensors, the kernel `csrc/rollout.cu` (a group of threads per
    lane, one in each warp of a thread block that takes one scenario's
    shooting block and up to 32 alphas; a serial loop over the block's steps;
    every scenario in one launch), or it raises.

`skip_mask` (M, Nf) marks steps that are not simulated; it defaults to the
horizon's last step k = N-1 (fpHelpers.cuh:235).

`make_kuka_bf16_rollout` returns the same op with the integrator step in
bfloat16 (`SolverConfig.bf16_rollout`): the feedback law stays float32, each
step casts x and u to bfloat16 and hands x back as float32
(`ops/integrators.py::make_bf16_step`):
  * on CPU tensors, its plain version `kuka_rollout_bf16_plain`, the same
    loop with the soa step made so;
  * on CUDA tensors, the kernel's bfloat16 entry (`pddp_rollout_bf16`: the
    group core on a bfloat16 scalar, `csrc/bf16_scalar.cuh`), or it raises.
It stands for no Pallas kernel: the JAX package runs this step as XLA ops
(`parallel_ddp_tpu/solver.py:124-141`).
"""

from __future__ import annotations

import functools

import torch

from parallel_ddp_tpu_torch.models.base import Plant
from parallel_ddp_tpu_torch.models.kuka import soa
from parallel_ddp_tpu_torch.ops import build
from parallel_ddp_tpu_torch.ops.cuda_rbd import consts_tensor
from parallel_ddp_tpu_torch.ops.integrators import make_bf16_step, make_step

NJ = 7
NS = 14
# A thread block of the kernel stages the inputs of its shooting block's Nf
# steps in shared memory beside the dynamics' workspace: the most it can take
# (the layout of csrc/rollout.cu in 227 KB)
MAX_BLOCK_STEPS = 418


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
    return _lanes_plain(_kuka_step(ee_type, float(gravity), integrator, dt),
                        x_swept, u, K, du, xp, alphas, skip, m_blocks)


def kuka_rollout_bf16_plain(x_swept, u, K, du, xp, alphas, skip, *, ee_type: int,
                            gravity: float, integrator: int, dt: float, m_blocks: int):
    """Plain version of `kuka_rollout_bf16_cuda`: the same loop with the soa
    step in bfloat16 (`make_bf16_step`)."""
    return _lanes_plain(make_bf16_step(_kuka_step(ee_type, float(gravity), integrator, dt)),
                        x_swept, u, K, du, xp, alphas, skip, m_blocks)


def _lanes_plain(step, x_swept, u, K, du, xp, alphas, skip, m_blocks):
    """`rollout_plain` over the lanes of the kernel's inputs with `step`."""
    *lead, A, N, _ = x_swept.shape
    lead = tuple(lead)
    M = m_blocks
    nf = N // M
    per_scen = lambda t, *tail: t.reshape(lead + (1, M, nf) + tail)
    return rollout_plain(
        step, x_swept.reshape(lead + (A, M, nf, NS))[..., 0, :], per_scen(u, NJ),
        per_scen(K, NJ, NS), per_scen(du, NJ), per_scen(xp, NS),
        alphas.to(x_swept.dtype)[:, None], skip.to(torch.bool))


def kuka_rollout_cuda(x_swept, u, K, du, xp, alphas, skip, *, ee_type: int,
                      gravity: float, integrator: int, dt: float, m_blocks: int):
    """Launch the rollout kernel on S = prod(...) scenarios: x_swept
    (..., A, N, 14), u (..., N, 7) etc.; alphas (A,) and skip (M, Nf) uint8
    shared; float32."""
    out = _launch_rollout("pddp_rollout", x_swept, u, K, du, xp, alphas, skip, ee_type,
                          gravity, integrator, dt, m_blocks)
    kuka_rollout_cuda.counter.hit(x_swept.device)
    return out


def kuka_rollout_bf16_cuda(x_swept, u, K, du, xp, alphas, skip, *, ee_type: int,
                           gravity: float, integrator: int, dt: float, m_blocks: int):
    """Launch the rollout kernel's bfloat16 entry: `kuka_rollout_cuda`'s
    arguments and float32 inputs and outputs, each integrator step in
    bfloat16."""
    out = _launch_rollout("pddp_rollout_bf16", x_swept, u, K, du, xp, alphas, skip, ee_type,
                          gravity, integrator, dt, m_blocks)
    kuka_rollout_bf16_cuda.counter.hit(x_swept.device)
    return out


def _launch_rollout(entry, x_swept, u, K, du, xp, alphas, skip, ee_type, gravity,
                    integrator, dt, m_blocks):
    """Check the inputs and launch the rollout kernel's `entry` into new
    outputs."""
    *lead, A, N, _ = x_swept.shape
    lead = tuple(lead)
    S = 1
    for d in lead:
        S *= d
    M = m_blocks
    if N % M:
        raise ValueError(f"horizon {N} not divisible into {M} shooting blocks")
    nf = N // M
    if nf > MAX_BLOCK_STEPS:
        raise ValueError(f"{nf} steps a shooting block: the rollout kernel stages at most "
                         f"{MAX_BLOCK_STEPS} in a thread block's shared memory (use more blocks)")
    build.check_input("x_swept", x_swept, lead + (A, N, NS))
    build.check_input("u", u, lead + (N, NJ))
    build.check_input("K", K, lead + (N, NJ, NS))
    build.check_input("du", du, lead + (N, NJ))
    build.check_input("xp", xp, lead + (N, NS))
    build.check_input("alphas", alphas, (A,))
    build.check_input("skip", skip, (M, nf), torch.uint8)
    for t in (u, K, du, xp, alphas, skip):
        if t.device != x_swept.device:
            raise ValueError("all rollout inputs must be on one device")
    if integrator not in (1, 2, 3):
        raise ValueError(f"unknown integrator {integrator}")
    xout = torch.empty(lead + (A, M, nf, NS), device=x_swept.device, dtype=torch.float32)
    uout = torch.empty(lead + (A, M, nf, NJ), device=x_swept.device, dtype=torch.float32)
    cc = consts_tensor(ee_type, float(gravity), x_swept.device)
    build.launch(
        entry, x_swept.device,
        cc.data_ptr(), x_swept.data_ptr(), u.data_ptr(), K.data_ptr(),
        du.data_ptr(), xp.data_ptr(), alphas.data_ptr(), skip.data_ptr(),
        xout.data_ptr(), uout.data_ptr(), S, A, M, nf, integrator,
        dt, 0.5 * dt, dt / 6.0)
    return xout, uout


kuka_rollout_cuda.counter = build.launch_counter("rollout")
kuka_rollout_bf16_cuda.counter = build.launch_counter("rollout_bf16")


def make_kuka_fused_rollout(ee_type: int, gravity: float, integrator: int,
                            dt: float, num_time_steps: int, m_blocks_f: int,
                            num_alpha: int):
    """Factory for the solver hook (`Plant.fused_rollout`); see the module
    docstring for the contract.  Raises if the horizon does not split into
    `m_blocks_f` equal blocks."""
    return _make_fused(kuka_rollout_plain, kuka_rollout_cuda, ee_type, gravity, integrator, dt,
                       num_time_steps, m_blocks_f, num_alpha)


def make_kuka_bf16_rollout(ee_type: int, gravity: float, integrator: int,
                           dt: float, num_time_steps: int, m_blocks_f: int,
                           num_alpha: int):
    """Factory for the bfloat16 solver hook (`Plant.fused_rollout_bf16`):
    `make_kuka_fused_rollout`'s contract with the step in bfloat16."""
    return _make_fused(kuka_rollout_bf16_plain, kuka_rollout_bf16_cuda, ee_type, gravity,
                       integrator, dt, num_time_steps, m_blocks_f, num_alpha)


def _make_fused(plain, cuda, ee_type, gravity, integrator, dt, num_time_steps, m_blocks_f,
                num_alpha):
    N, M = num_time_steps, m_blocks_f
    if N % M:
        raise ValueError(f"num_time_steps {N} not divisible by m_blocks_f {M}")
    nf = N // M
    default_skip = {}

    def _default_skip(device):
        # only k = N-1 is skipped; cached as the kernel takes it (uint8)
        if device not in default_skip:
            k = torch.arange(N, device=device).reshape(M, nf)
            default_skip[device] = (k == N - 1).to(torch.uint8).contiguous()
        return default_skip[device]

    def fused(x_swept, u, K, du, xp, alphas, skip_mask=None):
        A = alphas.shape[0]
        if A != num_alpha:
            raise ValueError(f"expected {num_alpha} alphas, got {A}")
        dev = x_swept.device
        skip = (_default_skip(dev) if skip_mask is None
                else (skip_mask != 0).to(dev, torch.uint8).contiguous())
        kw = dict(ee_type=ee_type, gravity=gravity, integrator=integrator, dt=dt,
                  m_blocks=M)
        if dev.type == "cpu":
            return plain(x_swept, u, K, du, xp, alphas, skip, **kw)
        return cuda(
            x_swept.contiguous(), u.contiguous(), K.contiguous(),
            du.contiguous(), xp.contiguous(), alphas.contiguous(), skip, **kw)

    return fused
