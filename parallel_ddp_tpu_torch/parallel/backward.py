"""Block-parallel backward pass (twin of `parallel_ddp_tpu/parallel/backward.py`;
bpHelpers.cuh).

The horizon is split into `m_blocks_b` time blocks swept in parallel: non-final
blocks seed their boundary cost-to-go from the PREVIOUS iteration's values
Pp/pp (the reference's FORCE_PARALLEL semantics, bpHelpers.cuh:356-420).
Each block is a serial sweep back in time; the blocks are a batch dimension
(the reference's `backPassKern<<<M_BLOCKS_B, (8,7)>>>`).

Per step (bpHelpers.cuh:37-334), with V_{k+1} = (P, p):
  p~   = p + P @ d_k                      on multiple-shooting defect boundaries
  Hxx += A'PA    Hxu += A'PB              (P unregularized)
  Hux += B'P+A   Huu += B'P+B             (P+ = P + rho*I; Tassa STATE_REG)
  K = Huu^-1 Hux    du = Huu^-1 gu        (Cholesky; PD failure -> rho retry)
  P' = Hxx + K'HuuK - HxuK - K'Hux        p' = gx + K'Huu du - Hxu du - K'gu
  ApBK = A - BK     Bdu = B du            dJexp += (du . gu, du . Huu du)

With `cfg.pallas_riccati` one rho attempt is one call of the fused Riccati
op (`ops/cuda_riccati.py`); otherwise the sweep is the per-step loop below.
The rho-retry loop reads its exit flag on the host: one device sync per
attempt.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from parallel_ddp_tpu_torch.config import SolverConfig
from parallel_ddp_tpu_torch.ops.linalg import chol_solve_unrolled


class BackwardPassResult(NamedTuple):
    P: torch.Tensor      # (N, n, n) cost-to-go Hessian at each step
    p: torch.Tensor      # (N, n) cost-to-go gradient
    K: torch.Tensor      # (N, m, n) feedback gains (row N-1 zero)
    du: torch.Tensor     # (N, m) feedforward steps (row N-1 zero)
    ApBK: torch.Tensor   # (N, n, n) A - B@K
    Bdu: torch.Tensor    # (N, n) B@du
    dJexp: torch.Tensor  # (2,) expected-reduction terms
    fail: torch.Tensor   # bool: any Huu factorization failed
    rho: torch.Tensor    # regularizer after retries
    drho: torch.Tensor
    host_syncs: int      # exit-flag reads of the rho-retry loop (one per attempt)


def make_riccati_step(cfg: SolverConfig, n: int, m: int):
    """Build the per-step Riccati/DDP recursion (bpHelpers.cuh:37-334),
    batched over any leading (lane) dims.  Returns
    step(rho, (P, p), (ab, Hk, gk, dk, k)) -> ((P', p'), per-step outputs);
    rho is a tensor broadcastable to the lane dims (per lane or scalar)."""
    nf = cfg.num_time_steps - 1
    n_blocks_f = cfg.n_blocks_f

    def step(rho, carry, inputs):
        P, p = carry
        ab, Hk, gk, dk, k = inputs
        is_terminal = k == nf
        eye_m = torch.eye(m, dtype=ab.dtype, device=ab.device)
        rho_b = rho[..., None, None]

        A = ab[..., :n]
        B = ab[..., n:]

        # defect coupling on shooting boundaries (bpHelpers.cuh:67-81)
        if cfg.m_blocks_f > 1:
            on_defect = torch.logical_and((k + 1) % n_blocks_f == 0, k < nf)
            Pd = (P @ dk[..., None])[..., 0]
            p_t = p + torch.where(on_defect[..., None], Pd, torch.zeros_like(p))
        else:
            p_t = p

        # Tassa STATE_REG asymmetry: x-rows see P, u-rows see P + rho*I
        Pab = P @ ab
        if cfg.state_reg:
            Pab_u = Pab + rho_b * ab
            G_x = A.mT @ Pab
            G_u = B.mT @ Pab_u
            Hq = Hk + torch.cat([G_x, G_u], dim=-2)
        else:
            Hq = Hk + ab.mT @ Pab
            reg = torch.zeros((n + m, n + m), dtype=ab.dtype, device=ab.device)
            reg[n:, n:] = eye_m
            Hq = Hq + rho_b * reg
        Hxx = Hq[..., :n, :n]
        Hxu = Hq[..., :n, n:]
        Hux = Hq[..., n:, :n]
        Huu = Hq[..., n:, n:]
        gq = gk + (ab.mT @ p_t[..., None])[..., 0]
        gx = gq[..., :n]
        gu = gq[..., n:]

        # PD test + solve via unrolled Cholesky; the terminal row gets Huu + I
        term_f = is_terminal.to(ab.dtype)[..., None, None]
        Huu_safe = Huu + term_f * eye_m
        rhs = torch.cat([Hux, gu[..., None]], dim=-1)
        sol, pd_ok = chol_solve_unrolled(Huu_safe, rhs)
        fail_k = torch.logical_and(~pd_ok, ~is_terminal)
        Kk = sol[..., :n]
        duk = sol[..., n]

        if cfg.state_reg:
            StZ = sol.mT @ rhs
            HxuS = Hxu @ sol
            P_new = Hxx + StZ[..., :n, :n] - HxuS[..., :n] - (sol[..., :n].mT @ Hux)
            p_new = (gx + StZ[..., :n, n] - HxuS[..., n]
                     - (sol[..., :n].mT @ gu[..., None])[..., 0])
        else:
            HxuS = Hxu @ sol
            P_new = Hxx - HxuS[..., :n]
            p_new = gx - HxuS[..., n]

        BS = B @ sol
        ApBKk = A - BS[..., :n]
        Bduk = BS[..., n]

        # terminal "step" (k == N-1): emit the seed untouched, zero gains
        t1 = is_terminal[..., None]
        t2 = is_terminal[..., None, None]
        Kk = torch.where(t2, torch.zeros_like(Kk), Kk)
        duk = torch.where(t1, torch.zeros_like(duk), duk)
        P_out = torch.where(t2, P, P_new)
        p_out = torch.where(t1, p, p_new)
        ApBKk = torch.where(t2, torch.zeros_like(ApBKk), ApBKk)
        Bduk = torch.where(t1, torch.zeros_like(Bduk), Bduk)
        dj = torch.stack([
            (duk * gu).sum(-1),
            (duk * (Huu @ duk[..., None])[..., 0]).sum(-1),
        ], dim=-1)
        dj = torch.where(t1, torch.zeros_like(dj), dj)
        return (P_out, p_out), (P_out, p_out, Kk, duk, ApBKk, Bduk, dj, fail_k)

    return step


def run_block(step, rho, seed_P, seed_p, ab_b, H_b, g_b, d_b, k_b):
    """Serial Riccati sweep of time blocks, k descending (backPassKern's
    in-block recursion), batched over leading lane dims: ab_b (..., Nb, n, n+m)
    etc.  Returns the per-step outputs in ascending k, (..., Nb, ...)."""
    carry = (seed_P, seed_p)
    outs = []
    for t in reversed(range(ab_b.shape[-3])):
        carry, o = step(rho, carry, (ab_b[..., t, :, :], H_b[..., t, :, :],
                                     g_b[..., t, :], d_b[..., t, :], k_b[..., t]))
        outs.append(o)
    outs.reverse()
    lane_dims = k_b.dim() - 1
    return tuple(torch.stack(field, dim=lane_dims) for field in zip(*outs))


def backward_pass(
    cfg: SolverConfig,
    AB: torch.Tensor,    # (N-1, n, n+m)
    H: torch.Tensor,     # (N, n+m, n+m)
    g: torch.Tensor,     # (N, n+m)
    Pp: torch.Tensor,    # (N, n, n) previous-iteration CTG (block boundary seeds)
    pp: torch.Tensor,    # (N, n)
    d: torch.Tensor,     # (N, n) defects
    x: torch.Tensor,     # (N, n) current trajectory
    xp2: torch.Tensor,   # (N, n) trajectory at which Pp/pp were computed
    rho0: torch.Tensor,
    drho0: torch.Tensor,
) -> BackwardPassResult:
    """Full backward pass with the rho-retry loop (backwardPassGPU,
    bpHelpers.cuh:483-517)."""
    if cfg.bp_assoc_scan:
        raise NotImplementedError(
            "bp_assoc_scan (the associative-scan backward pass) is not ported")
    N = cfg.num_time_steps
    Mb = cfg.m_blocks_b
    Nb = cfg.n_blocks_b
    n = x.shape[-1]
    m = AB.shape[-1] - n
    nf = N - 1

    # pad AB with a zero row at k = N-1 so every block has Nb uniform steps
    AB_pad = torch.cat([AB, torch.zeros((1, n, n + m), dtype=AB.dtype, device=AB.device)])

    # block seeds: the final block starts from the terminal expansion
    # (bpHelpers.cuh:361-367), the others from the previous iteration's
    # cost-to-go at their boundary k = (b+1)*Nb, optionally transported through
    # the state change (linearXfrmOrLoad, bpHelpers.cuh:16-34)
    P_seed = Pp[Nb:N:Nb]
    p_seed = pp[Nb:N:Nb]
    if cfg.linear_transform_switch:
        dx = x[Nb:N:Nb] - xp2[Nb:N:Nb]
        p_seed = p_seed + (P_seed @ dx[..., None])[..., 0]
    seeds_P = torch.cat([P_seed, H[nf, :n, :n][None]])
    seeds_p = torch.cat([p_seed, g[nf, :n][None]])

    AB_blk = AB_pad.reshape(Mb, Nb, n, n + m)
    H_blk = H.reshape(Mb, Nb, n + m, n + m)
    g_blk = g.reshape(Mb, Nb, n + m)
    d_blk = d.reshape(Mb, Nb, n)
    k_blk = torch.arange(N, device=x.device).reshape(Mb, Nb)

    if cfg.pallas_riccati:
        # the fused sweep: one op call per rho attempt (backPassKern twin)
        from parallel_ddp_tpu_torch.ops.cuda_riccati import make_riccati_block_call

        fused_bp = make_riccati_block_call(cfg, n, m)

        def attempt(rho):
            return fused_bp(rho, seeds_P, seeds_p, AB_blk, H_blk, g_blk, d_blk, k_blk)
    else:
        step = make_riccati_step(cfg, n, m)

        def attempt(rho):
            outs = run_block(step, rho, seeds_P, seeds_p, AB_blk, H_blk, g_blk,
                             d_blk, k_blk)
            P_o, p_o, K_o, du_o, ApBK_o, Bdu_o, dj_o, fail_o = outs
            flat = lambda a: a.reshape((N,) + a.shape[2:])
            return (flat(P_o), flat(p_o), flat(K_o), flat(du_o), flat(ApBK_o),
                    flat(Bdu_o), dj_o.sum(dim=(0, 1)), fail_o.any())

    # rho-retry loop (backwardPassGPU, bpHelpers.cuh:489-515) with a safety
    # cap; its exit flag is read on the host (one sync per attempt)
    rho, drho = rho0, drho0
    out = attempt(rho)
    retries = syncs = 0
    while retries < cfg.max_bp_retries:
        syncs += 1
        if not bool(out[7]):
            break
        drho = torch.clamp(drho * cfg.rho_factor, min=cfg.rho_factor)
        rho = torch.clamp(rho * drho, max=cfg.rho_max)
        out = attempt(rho)
        retries += 1
    P_o, p_o, K_o, du_o, ApBK_o, Bdu_o, dJexp, fail = out
    return BackwardPassResult(P_o, p_o, K_o, du_o, ApBK_o, Bdu_o, dJexp, fail,
                              rho, drho, syncs)
