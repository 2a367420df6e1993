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
With `cfg.bp_assoc_scan` an attempt is instead the EXACT log-depth pass
(`_assoc_attempt`): no blocks and no stale seeds, the recursion as a reverse
associative scan (`parallel/scan.py`) of linear-fractional step maps.
The rho-retry loop is a `graphs.while_loop`: a WHILE node of the graph being
captured on the card (the device decides how many attempts run), a host loop
on the CPU that reads its exit flag once per attempt.

A batch of scenarios is a leading axis on every input: seeds, blocks, rho
and the retry state get it, and the sweep's lanes are scenarios x blocks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from parallel_ddp_tpu_torch import graphs
from parallel_ddp_tpu_torch.config import SolverConfig
from parallel_ddp_tpu_torch.ops.linalg import chol_solve_unrolled
from parallel_ddp_tpu_torch.parallel.scan import associative_scan


class BackwardPassResult(NamedTuple):
    """One problem's, or with a leading scenario axis, each scenario's."""
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
    host_syncs: int      # exit-flag reads of the rho-retry loop (one per attempt;
                         # none under capture)


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
    etc.; k_b (..., Nb) may leave out leading lane dims it shares.  Returns the
    per-step outputs in ascending k, (..., Nb, ...)."""
    carry = (seed_P, seed_p)
    outs = []
    for t in reversed(range(ab_b.shape[-3])):
        carry, o = step(rho, carry, (ab_b[..., t, :, :], H_b[..., t, :, :],
                                     g_b[..., t, :], d_b[..., t, :], k_b[..., t]))
        outs.append(o)
    outs.reverse()
    lane_dims = ab_b.dim() - 3
    return tuple(torch.stack(field, dim=lane_dims) for field in zip(*outs))


def _solve(a, b):
    """a^-1 b for batches of small square a (LU with partial pivoting), with
    no host read: `solve_ex` with its checks off.  A singular a gives
    non-finite values, which the Riccati step's Cholesky test then fails.
    Callers stack their solves so that one call has a batch of at least 2
    and a matrix right-hand side: on the card, torch sends a batch of one
    with a single right-hand column to a cuSOLVER path that a CUDA graph
    cannot capture (`scripts/torch_lu_capture_probe.py`)."""
    return torch.linalg.solve_ex(a, b, check_errors=False)[0]


def _assoc_attempt(cfg: SolverConfig, step, AB_pad, H, g, d, rho):
    """One rho attempt of the EXACT log-depth backward pass (bp_assoc_scan;
    the twin of the reference package's `_assoc_attempt`), over leading
    scenario dims: AB_pad (..., N, n, n+m), H (..., N, n+m, n+m),
    g (..., N, n+m), d (..., N, n), rho (...).

    Each LQR step is a linear-fractional map on the cost-to-go
    V(x) = 0.5 x'Px + p'x,
        P_i = J + F' P (I + C P)^-1 F,   p_i = eta + F' (I + P C)^-1 (p + P z),
    a family closed under composition, and the composition is associative
    (Sarkka & Garcia-Fernandez, IEEE TAC 2021, Lemma 8).  A reverse
    `associative_scan` of the per-step elements gives the suffix products
    G_k = e_k o ... o e_{N-2}; each applied to the terminal expansion is V_k,
    and one application of the serial pass's step over all N knots at once
    (k a lane tensor) gives the gains and every other output.  Shooting
    defects enter as affine offsets z_k = d_k on block boundaries.  Needs
    plain regularization (state_reg=False): Huu + rho I is R~ = R + rho I.
    `fail` is reduced over time only, one flag per scenario."""
    N = cfg.num_time_steps
    nf = N - 1
    n = AB_pad.shape[-2]
    m = AB_pad.shape[-1] - n
    t_dim = AB_pad.dim() - 3
    eye_m = torch.eye(m, dtype=H.dtype, device=H.device)
    eye_n = torch.eye(n, dtype=H.dtype, device=H.device)

    A = AB_pad[..., :nf, :, :n]
    B = AB_pad[..., :nf, :, n:]
    Q = H[..., :nf, :n, :n]
    Mx = H[..., :nf, :n, n:]
    R = H[..., :nf, n:, n:]
    gx = g[..., :nf, :n]
    gu = g[..., :nf, n:]

    # affine offsets: the shooting defect at block boundaries
    c = torch.zeros_like(d[..., :nf, :])
    if cfg.m_blocks_f > 1:
        nb = cfg.n_blocks_f
        c[..., nb - 1::nb, :] = d[..., nb - 1:nf:nb, :]

    # per-step elements, R~ = R + rho I factorized once per step
    R_reg = R + rho[..., None, None, None] * eye_m
    rhs = torch.cat([Mx.mT, B.mT, gu[..., None]], dim=-1)
    sol, pd_ok = chol_solve_unrolled(R_reg, rhs)           # (..., nf, m, 2n+1)
    RiMt = sol[..., :n]                                     # R~^-1 M'
    RiBt = sol[..., n:2 * n]                                # R~^-1 B'
    Rigu = sol[..., 2 * n]                                  # R~^-1 gu
    F = A - B @ RiMt
    C = B @ RiBt
    J = Q - Mx @ RiMt
    z = c - (B @ Rigu[..., None])[..., 0]
    eta = gx - (Mx @ Rigu[..., None])[..., 0]

    def combine(ei, ej):
        """Compose: ei earlier in time, ej later."""
        Fi, zi, Ci, Ji, etai = ei
        Fj, zj, Cj, Jj, etaj = ej
        # D = Fj (I + Ci Jj)^-1,  E = Fi' (I + Jj Ci)^-1: one stacked solve
        ICJ = eye_n + Ci @ Jj
        IJC = eye_n + Jj @ Ci
        Dt, Et = _solve(torch.stack([ICJ.mT, IJC.mT]), torch.stack([Fj.mT, Fi]))
        D, E = Dt.mT, Et.mT
        F12 = D @ Fi
        z12 = (D @ (zi - (Ci @ etaj[..., None])[..., 0])[..., None])[..., 0] + zj
        C12 = D @ Ci @ Fj.mT + Cj
        eta12 = (E @ (etaj + (Jj @ zi[..., None])[..., 0])[..., None])[..., 0] + etai
        J12 = E @ Jj @ Fi + Ji
        return F12, z12, C12, J12, eta12

    # suffix products; the reverse scan hands fn (later, earlier)
    Fs, zs, Cs, Js, etas = associative_scan(lambda a, b: combine(b, a), (F, z, C, J, eta),
                                            dim=t_dim, reverse=True)

    # V_k = G_k applied to the terminal expansion (bpHelpers.cuh:361-367):
    # P_k = J + F' P (I + C P)^-1 F and p_k = eta + W' (p + P z) with
    # W = (I + C' P)^-1 F = (I + P C)^-T F, both from one stacked solve
    P_term = H[..., nf, None, :n, :n]
    p_term = g[..., nf, None, :n]
    S = _solve(torch.stack([eye_n + Cs @ P_term, eye_n + Cs.mT @ P_term]),
               torch.stack([Fs, Fs]))
    P_all = Js + Fs.mT @ P_term @ S[0]
    p_all = etas + (S[1].mT @ (p_term + (P_term @ zs[..., None])[..., 0])[..., None])[..., 0]
    # the carry of step k is V_{k+1}; the terminal row consumes V_term itself
    P_next = torch.cat([P_all[..., 1:, :, :], P_term, P_term], dim=t_dim)
    p_next = torch.cat([p_all[..., 1:, :], p_term, p_term], dim=t_dim)

    ks = torch.arange(N, device=H.device)
    _, (P_o, p_o, K_o, du_o, ApBK_o, Bdu_o, dj_o, fail_o) = step(
        rho[..., None], (P_next, p_next), (AB_pad, H, g, d, ks))
    fail = torch.logical_or(fail_o.any(-1), (~pd_ok).any(-1))
    return P_o, p_o, K_o, du_o, ApBK_o, Bdu_o, dj_o.sum(-2), fail


def per_scenario_mask(mask, t):
    """A flag per scenario, mask (...), broadcast against t (..., more dims)."""
    return mask.reshape(mask.shape + (1,) * (t.dim() - mask.dim()))


def _block_attempt(cfg: SolverConfig, AB_pad, H, g, Pp, pp, d, x, xp2):
    """One rho attempt of the block-parallel pass, as a function of rho:
    the fused Riccati op's sweep (`cfg.pallas_riccati`) or the per-step
    loop, over `m_blocks_b` blocks seeded from the previous iteration."""
    N = cfg.num_time_steps
    Mb = cfg.m_blocks_b
    Nb = cfg.n_blocks_b
    n = x.shape[-1]
    m = AB_pad.shape[-1] - n
    nf = N - 1
    lead = AB_pad.shape[:-3]

    # block seeds: the final block starts from the terminal expansion
    # (bpHelpers.cuh:361-367), the others from the previous iteration's
    # cost-to-go at their boundary k = (b+1)*Nb, optionally transported through
    # the state change (linearXfrmOrLoad, bpHelpers.cuh:16-34)
    P_seed = Pp[..., Nb:N:Nb, :, :]
    p_seed = pp[..., Nb:N:Nb, :]
    if cfg.linear_transform_switch:
        dx = x[..., Nb:N:Nb, :] - xp2[..., Nb:N:Nb, :]
        p_seed = p_seed + (P_seed @ dx[..., None])[..., 0]
    seeds_P = torch.cat([P_seed, H[..., nf, None, :n, :n]], dim=-3)
    seeds_p = torch.cat([p_seed, g[..., nf, None, :n]], dim=-2)

    AB_blk = AB_pad.reshape(lead + (Mb, Nb, n, n + m))
    H_blk = H.reshape(lead + (Mb, Nb, n + m, n + m))
    g_blk = g.reshape(lead + (Mb, Nb, n + m))
    d_blk = d.reshape(lead + (Mb, Nb, n))
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
            outs = run_block(step, rho[..., None], seeds_P, seeds_p, AB_blk, H_blk, g_blk,
                             d_blk, k_blk)
            P_o, p_o, K_o, du_o, ApBK_o, Bdu_o, dj_o, fail_o = outs
            flat = lambda a: a.reshape(lead + (N,) + a.shape[len(lead) + 2:])
            return (flat(P_o), flat(p_o), flat(K_o), flat(du_o), flat(ApBK_o),
                    flat(Bdu_o), dj_o.sum(dim=(-3, -2)), fail_o.any(-1).any(-1))
    return attempt


def backward_pass(
    cfg: SolverConfig,
    AB: torch.Tensor,    # (..., N-1, n, n+m)
    H: torch.Tensor,     # (..., N, n+m, n+m)
    g: torch.Tensor,     # (..., N, n+m)
    Pp: torch.Tensor,    # (..., N, n, n) previous-iteration CTG (block boundary seeds)
    pp: torch.Tensor,    # (..., N, n)
    d: torch.Tensor,     # (..., N, n) defects
    x: torch.Tensor,     # (..., N, n) current trajectory
    xp2: torch.Tensor,   # (..., N, n) trajectory at which Pp/pp were computed
    rho0: torch.Tensor,  # (...)
    drho0: torch.Tensor,  # (...)
) -> BackwardPassResult:
    """Full backward pass with the rho-retry loop (backwardPassGPU,
    bpHelpers.cuh:483-517), for one problem or, with leading scenario dims
    "...", a batch of independent ones (the reference's vmap over its
    while_loop): each scenario retries under its own fail & (tries < max),
    and the loop runs while any scenario still does."""
    n = x.shape[-1]
    m = AB.shape[-1] - n
    lead = AB.shape[:-3]

    # pad AB with a zero row at k = N-1 so every block has Nb uniform steps
    AB_pad = torch.cat([AB, AB.new_zeros(lead + (1, n, n + m))], dim=-3)

    if cfg.bp_assoc_scan:
        # the exact log-depth pass: no blocks, no stale boundary seeds
        step = make_riccati_step(cfg, n, m)

        def attempt(rho):
            return _assoc_attempt(cfg, step, AB_pad, H, g, d, rho)
    else:
        attempt = _block_attempt(cfg, AB_pad, H, g, Pp, pp, d, x, xp2)

    return rho_retry(cfg, attempt, rho0, drho0)


def rho_retry(cfg: SolverConfig, attempt, rho0: torch.Tensor,
              drho0: torch.Tensor) -> BackwardPassResult:
    """The rho-retry loop around attempt(rho) -> (P, p, K, du, ApBK, Bdu,
    dJexp, fail) (backwardPassGPU, bpHelpers.cuh:489-515; the reference
    package's retry_cond / retry_body) with a safety cap, one scenario per
    entry of fail.  The first attempt's outputs, rho and drho are the loop's
    state: each retry commits under its scenario's fail & (tries < max), so
    a retry that was not needed changes nothing."""
    out = list(attempt(rho0))
    rho, drho = rho0.clone(), drho0.clone()
    tries = torch.zeros(out[7].shape, dtype=torch.int32, device=out[7].device)

    def retrying():
        return torch.logical_and(out[7], tries < cfg.max_bp_retries)

    def retry_body(_):
        go = retrying()
        drho_new = torch.clamp(drho * cfg.rho_factor, min=cfg.rho_factor)
        rho_new = torch.clamp(rho * drho_new, max=cfg.rho_max)
        for held, new in zip(out, attempt(rho_new)):
            held.copy_(torch.where(per_scenario_mask(go, held), new, held))
        drho.copy_(torch.where(go, drho_new, drho))
        rho.copy_(torch.where(go, rho_new, rho))
        tries.add_(go.to(torch.int32))

    syncs = graphs.while_loop(lambda: retrying().any(), retry_body, cfg.max_bp_retries)
    P_o, p_o, K_o, du_o, ApBK_o, Bdu_o, dJexp, fail = out
    return BackwardPassResult(P_o, p_o, K_o, du_o, ApBK_o, Bdu_o, dJexp, fail,
                              rho, drho, syncs)
