"""Forward pass: sweep, multiple-shooting rollout, cost, defects, line search
(twin of `parallel_ddp_tpu/parallel/forward.py`; fpHelpers.cuh).

  * the forward SWEEP's linear recurrence
        e_{k+1} = (A_k - B_k K_k) e_k + (-alpha * B_k du_k + d_k on boundaries)
    (fpHelpers.cuh:17-53) is a serial loop over the horizon, batched over the
    line-search alphas (the reference package uses a log-depth associative
    scan; torch has none, and a log-depth version is later work);
  * the multiple-shooting ROLLOUT runs every (alpha, shooting block) lane at
    once, through the plant's fused rollout op when it has one;
  * per-alpha COST and DEFECT reductions are batched reductions;
  * the LINE SEARCH over alphas (fpHelpers.cuh:395-408) is a masked argmax
    that stays on the device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from parallel_ddp_tpu_torch.config import SolverConfig
from parallel_ddp_tpu_torch.ops.cuda_rollout import rollout_plain


def sweep_combine(a, b):
    """Associative composition of affine sweep elements (M, V): e' = M e + V,
    V batched over alphas (a then b)."""
    m1, v1 = a
    m2, v2 = b
    return (
        torch.einsum("...ij,...jk->...ik", m2, m1),
        torch.einsum("...ij,...aj->...ai", m2, v1) + v2,
    )


def make_sim_block(step_fn: Callable, nf: int):
    """Per-(alpha, shooting-block) nonlinear rollout body (forwardSimInner,
    fpHelpers.cuh:223-275): u_k = u_k - alpha*du_k - K_k (x_k - xp_k), then
    integrate; the horizon's very last step (k == nf) is never simulated
    (fpHelpers.cuh:235).  Batched over broadcastable leading dims (see
    `ops/cuda_rollout.py::rollout_plain`)."""

    def sim_block(alpha, x0, u_b, K_b, du_b, xp_b, k_b):
        return rollout_plain(step_fn, x0, u_b, K_b, du_b, xp_b, alpha, k_b == nf)

    return sim_block


def forward_sweep(
    cfg: SolverConfig,
    ApBK: torch.Tensor,   # (N, n, n)
    Bdu: torch.Tensor,    # (N, n)
    d: torch.Tensor,      # (N, n)
    x: torch.Tensor,      # (N, n) accepted trajectory
    xp: torch.Tensor,     # (N, n) previous trajectory (kept for parity)
    alphas: torch.Tensor,  # (A,)
) -> torch.Tensor:
    """x_swept per alpha: (A, N, n), with e_0 = 0 and
    e_{k+1} = ApBK_k e_k + c_k(alpha), c_k = -alpha*Bdu_k + 1{boundary}(k) d_k."""
    N = cfg.num_time_steps
    n = x.shape[-1]
    A = alphas.shape[0]
    c = -alphas[None, :, None] * Bdu[:-1, None, :]            # (N-1, A, n)
    # defect boundaries: k = b*Nf - 1 for b = 1..M-1 (k < N-1)
    nb = cfg.n_blocks_f
    c[nb - 1:N - 1:nb] = c[nb - 1:N - 1:nb] + d[nb - 1:N - 1:nb, None, :]
    e = torch.zeros((A, n), dtype=x.dtype, device=x.device)
    es = [e]
    for k in range(N - 1):
        e = torch.addmm(c[k], e, ApBK[k].mT)
        es.append(e)
    return x[None] + torch.stack(es, dim=1)


class RolloutResult(NamedTuple):
    x: torch.Tensor      # (A, N, n) candidate trajectories
    u: torch.Tensor      # (A, N, m) candidate controls
    d: torch.Tensor      # (A, N, n) candidate defects (nonzero on boundaries)
    J: torch.Tensor      # (A,) total cost
    max_defect: torch.Tensor  # (A,) max over boundaries of the L1 defect norm


def _total_cost(stage_cost, x_cand, u_cand):
    """Per-alpha total cost (costKern): stage costs over the time axis."""
    ks = torch.arange(x_cand.shape[-2], device=x_cand.device)
    return stage_cost(x_cand, u_cand, ks).sum(-1)


def multiple_shooting_rollout(
    cfg: SolverConfig,
    step_fn: Callable,
    stage_cost: Callable,   # (x (..., n), u (..., m), k (...)) -> (...)
    x_swept: torch.Tensor,  # (A, N, n)
    u: torch.Tensor,        # (N, m)
    K: torch.Tensor,        # (N, m, n)
    du: torch.Tensor,       # (N, m)
    xp: torch.Tensor,       # (N, n)
    alphas: torch.Tensor,   # (A,)
    fused_sim: Optional[Callable] = None,
) -> RolloutResult:
    """Simulate all (alpha, shooting block) pairs (forwardSimInner,
    fpHelpers.cuh:223-275).  The simulated state at a block's final step
    becomes the defect d = x_sim - x_swept[next block start] (:253-258)."""
    N = cfg.num_time_steps
    M = cfg.m_blocks_f
    Nf = cfg.n_blocks_f
    n = x_swept.shape[-1]
    m = u.shape[-1]
    A = alphas.shape[0]

    xs_blk = x_swept.reshape(A, M, Nf, n)
    if fused_sim is not None:
        x_next_all, u_new_all = fused_sim(x_swept, u, K, du, xp, alphas)
    else:
        sim_block = make_sim_block(step_fn, N - 1)
        k_blk = torch.arange(N, device=u.device).reshape(M, Nf)
        x_next_all, u_new_all = sim_block(
            alphas[:, None], xs_blk[:, :, 0], u.reshape(M, Nf, m),
            K.reshape(M, Nf, m, n), du.reshape(M, Nf, m), xp.reshape(M, Nf, n),
            k_blk)
    # x_next_all: (A, M, Nf, n); u_new_all: (A, M, Nf, m)

    # candidate trajectory: block starts from the sweep, interior from the sim
    x_cand = torch.cat([xs_blk[:, :, :1], x_next_all[:, :, :-1]], dim=2).reshape(A, N, n)
    u_cand = u_new_all.reshape(A, N, m)

    d_cand = torch.zeros((A, N, n), dtype=x_swept.dtype, device=x_swept.device)
    if M > 1:
        d_boundary = x_next_all[:, :-1, -1] - xs_blk[:, 1:, 0]     # (A, M-1, n)
        d_cand[:, Nf - 1:N - 1:Nf] = d_boundary
        # max-abs defect metric (defectKern, fpHelpers.cuh:94-111)
        max_defect = d_boundary.abs().sum(-1).amax(-1)
    else:
        max_defect = torch.zeros((A,), dtype=x_swept.dtype, device=x_swept.device)

    J = _total_cost(stage_cost, x_cand, u_cand)
    return RolloutResult(x_cand, u_cand, d_cand, J, max_defect)


def slq_rollout(
    cfg: SolverConfig,
    stage_cost: Callable,
    x: torch.Tensor,
    u: torch.Tensor,
    K: torch.Tensor,
    du: torch.Tensor,
    ApBK: torch.Tensor,
    Bdu: torch.Tensor,
    xp: torch.Tensor,
    alphas: torch.Tensor,
) -> RolloutResult:
    """SLQ forward pass: roll the LINEARIZED dynamics (forwardSimSLQInner,
    fpHelpers.cuh:573-632); no defects (single shooting)."""
    A = alphas.shape[0]
    x_cand = forward_sweep(cfg, ApBK, Bdu, torch.zeros_like(x), x, xp, alphas)
    dx = x_cand - xp[None]
    u_cand = (u[None] - alphas[:, None, None] * du[None]
              - torch.einsum("kmn,akn->akm", K, dx))
    J = _total_cost(stage_cost, x_cand, u_cand)
    zeros = torch.zeros((A,), dtype=x.dtype, device=x.device)
    return RolloutResult(x_cand, u_cand, torch.zeros_like(x_cand), J, zeros)


class LineSearchResult(NamedTuple):
    accept: torch.Tensor      # bool
    alpha_idx: torch.Tensor   # int (0 if rejected)
    J: torch.Tensor           # selected cost (prevJ if rejected)
    dJ: torch.Tensor          # cost reduction (-1 if rejected)
    z: torch.Tensor           # expected-reduction ratio
    max_defect: torch.Tensor  # selected defect
    ignore_defect: torch.Tensor  # updated flag
    best_dJ_frac: torch.Tensor   # max (prevJ - J)/prevJ over alphas
    any_feasible: torch.Tensor   # some candidate kept J non-increasing and
                                 # the defect in bound


def line_search(
    cfg: SolverConfig,
    J: torch.Tensor,           # (A,)
    max_defect: torch.Tensor,  # (A,)
    alphas: torch.Tensor,      # (A,)
    dJexp: torch.Tensor,       # (2,)
    prevJ: torch.Tensor,
    ignore_defect: torch.Tensor,
) -> LineSearchResult:
    """Accept the best (or first) alpha passing the J/z/defect tests
    (forwardSimGPU line-search scan, fpHelpers.cuh:395-408)."""
    cdJ = prevJ - J
    j_ok = cdJ >= 0.0
    expected = alphas * dJexp[0] + 0.5 * alphas * alphas * dJexp[1]
    z = cdJ / expected
    if cfg.use_exp_red:
        z_ok = torch.logical_and(z > cfg.exp_red_min, z < cfg.exp_red_max)
    else:
        z_ok = torch.ones_like(j_ok)
    if cfg.m_blocks_f > 1 and cfg.use_max_defect:
        d_ok = torch.logical_or(ignore_defect, max_defect < cfg.max_defect_size)
    else:
        d_ok = torch.ones_like(j_ok)
    valid = j_ok & z_ok & d_ok

    accept = valid.any()
    if cfg.alpha_best_switch:
        score = torch.where(valid, cdJ, torch.full_like(cdJ, -torch.inf))
        idx = torch.argmax(score)
    else:
        idx = torch.argmax(valid.to(torch.int32))  # first valid
    idx = torch.where(accept, idx, torch.zeros_like(idx))

    sel_d = max_defect.gather(0, idx.reshape(1))[0]
    new_ignore = torch.where(
        torch.logical_and(accept, sel_d < cfg.max_defect_size),
        torch.zeros_like(ignore_defect),
        ignore_defect,
    )
    tiny = torch.finfo(J.dtype).tiny
    return LineSearchResult(
        accept=accept,
        alpha_idx=idx,
        J=torch.where(accept, J.gather(0, idx.reshape(1))[0], prevJ),
        dJ=torch.where(accept, cdJ.gather(0, idx.reshape(1))[0], -torch.ones_like(prevJ)),
        z=torch.where(accept, z.gather(0, idx.reshape(1))[0], torch.zeros_like(prevJ)),
        max_defect=sel_d,
        ignore_defect=new_ignore,
        best_dJ_frac=cdJ.max() / torch.clamp(prevJ, min=tiny),
        any_feasible=(j_ok & d_ok).any(),
    )


def forward_pass(
    cfg: SolverConfig,
    step_fn: Callable,
    stage_cost: Callable,
    x: torch.Tensor,
    u: torch.Tensor,
    d: torch.Tensor,
    K: torch.Tensor,
    du: torch.Tensor,
    ApBK: torch.Tensor,
    Bdu: torch.Tensor,
    xp: torch.Tensor,
    alphas: torch.Tensor,
    fused_sim: Optional[Callable] = None,
) -> RolloutResult:
    """Sweep (if multiple shooting) + rollout for every alpha."""
    if cfg.slq:
        return slq_rollout(cfg, stage_cost, x, u, K, du, ApBK, Bdu, xp, alphas)
    if cfg.m_blocks_f > 1:
        x_swept = forward_sweep(cfg, ApBK, Bdu, d, x, xp, alphas)
    else:
        x_swept = x[None].expand((alphas.shape[0],) + tuple(x.shape))
    return multiple_shooting_rollout(
        cfg, step_fn, stage_cost, x_swept, u, K, du, xp, alphas,
        fused_sim=fused_sim,
    )
