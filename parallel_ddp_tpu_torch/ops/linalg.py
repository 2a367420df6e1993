"""Unrolled small-matrix linear algebra (twin of `parallel_ddp_tpu/ops/linalg.py`).

For the tiny fixed dims of this workload (Huu is n_ctrl x n_ctrl <= 7x7) a
fully unrolled Cholesky factor + solve, batched over any leading dims, with
the positive-definiteness test for free (any non-positive pivot argument).
"""

from __future__ import annotations

import torch


def chol_solve_unrolled(m, rhs, eps: float = 0.0):
    """Solve m @ X = rhs for symmetric positive-definite m, fully unrolled.

    m: (..., D, D); rhs: (..., D, R).  Returns (X (..., D, R), ok (...,) bool)
    where ok is the PD test (all Cholesky pivot arguments > eps).  On failure X
    is still finite: failed pivots are replaced by 1 (the reference's
    `linalg.py:39-41`); callers gate on `ok` (the rho-retry path)."""
    d = m.shape[-1]

    l_ch = [[None] * d for _ in range(d)]
    ok = None
    for j in range(d):
        acc = m[..., j, j]
        for k in range(j):
            acc = acc - l_ch[j][k] * l_ch[j][k]
        pos = acc > eps
        ok = pos if ok is None else torch.logical_and(ok, pos)
        l_ch[j][j] = torch.sqrt(torch.where(pos, acc, torch.ones_like(acc)))
        inv = 1.0 / l_ch[j][j]
        for i in range(j + 1, d):
            a2 = m[..., i, j]
            for k in range(j):
                a2 = a2 - l_ch[i][k] * l_ch[j][k]
            l_ch[i][j] = a2 * inv

    # triangular solves vectorized over all R right-hand sides at once
    z = [None] * d
    for i in range(d):
        acc = rhs[..., i, :]
        for k in range(i):
            acc = acc - l_ch[i][k][..., None] * z[k]
        z[i] = acc / l_ch[i][i][..., None]
    y = [None] * d
    for i in reversed(range(d)):
        acc = z[i]
        for k in range(i + 1, d):
            acc = acc - l_ch[k][i][..., None] * y[k]
        y[i] = acc / l_ch[i][i][..., None]
    return torch.stack(y, dim=-2), ok
