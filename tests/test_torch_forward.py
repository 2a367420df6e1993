"""The port's forward-pass pieces (parallel_ddp_tpu_torch/parallel/forward.py)
against the reference's, on the same seeded inputs: the forward sweep (a
serial loop here, an associative scan there), the sweep's combine rule, the
SLQ rollout and the line search.  Float32 in both; the sweep's products are
summed in another order, so allclose."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_ddp_tpu.config import SolverConfig as RefConfig
from parallel_ddp_tpu.parallel import forward as ref
from parallel_ddp_tpu_torch import interop
from parallel_ddp_tpu_torch.parallel import forward

N, n, m, A = 16, 4, 2, 5


def _sweep_inputs(seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (
        (0.9 * np.eye(n) + rng.normal(0, 0.1, (N, n, n))).astype(f32),   # ApBK
        rng.normal(0, 0.3, (N, n)).astype(f32),                          # Bdu
        rng.normal(0, 0.1, (N, n)).astype(f32),                          # d
        rng.normal(0, 0.5, (N, n)).astype(f32),                          # x
        np.power(np.float32(0.5), np.arange(A, dtype=f32)),              # alphas
    )


@pytest.mark.parametrize("m_blocks_f", [1, 2, 4])
def test_forward_sweep_matches_reference(m_blocks_f):
    cfg_ref = RefConfig(num_time_steps=N, m_blocks_b=4, m_blocks_f=m_blocks_f, num_alpha=A)
    ApBK, Bdu, d, x, al = _sweep_inputs(m_blocks_f)
    want = ref.forward_sweep(cfg_ref, *(jnp.asarray(a) for a in (ApBK, Bdu, d, x, x, al)))
    got = forward.forward_sweep(interop.solver_config(cfg_ref),
                                *(torch.as_tensor(a) for a in (ApBK, Bdu, d, x, x, al)))
    assert got.shape == (A, N, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_sweep_combine_composes_the_serial_sweep():
    """Folding the affine elements with `sweep_combine` reproduces the serial
    sweep — the rule a log-depth sweep will be built on."""
    cfg = interop.solver_config(RefConfig(num_time_steps=N, m_blocks_b=4, m_blocks_f=2,
                                          num_alpha=A))
    ApBK, Bdu, d, x, al = (torch.as_tensor(a) for a in _sweep_inputs(7))
    serial = forward.forward_sweep(cfg, ApBK, Bdu, d, x, x, al)
    nb = cfg.n_blocks_f
    acc = None
    for k in range(N - 1):
        c = -al[:, None] * Bdu[k] + (d[k] if (k + 1) % nb == 0 else 0.0)
        acc = (ApBK[k], c) if acc is None else forward.sweep_combine(acc, (ApBK[k], c))
        torch.testing.assert_close(x[k + 1] + acc[1], serial[:, k + 1], rtol=1e-5, atol=1e-5)


def test_slq_rollout_matches_reference():
    cfg_ref = RefConfig(num_time_steps=N, m_blocks_b=4, m_blocks_f=1, num_alpha=A, slq=True)
    rng = np.random.default_rng(3)
    ApBK, Bdu, _, x, al = _sweep_inputs(3)
    u = rng.normal(0, 1.0, (N, m)).astype(np.float32)
    K = rng.normal(0, 0.2, (N, m, n)).astype(np.float32)
    du = rng.normal(0, 0.3, (N, m)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)

    def ref_stage(xk, uk, k):
        return jnp.sum(jnp.asarray(w) * xk * xk) + 0.1 * jnp.sum(uk * uk) + 0.01 * k

    def stage(xk, uk, k):
        return (torch.as_tensor(w) * xk * xk).sum(-1) + 0.1 * (uk * uk).sum(-1) + 0.01 * k

    want = ref.slq_rollout(cfg_ref, ref_stage, *(jnp.asarray(a) for a in
                                                 (x, u, K, du, ApBK, Bdu, x, al)))
    got = forward.slq_rollout(interop.solver_config(cfg_ref), stage,
                              *(torch.as_tensor(a) for a in (x, u, K, du, ApBK, Bdu, x, al)))
    for name in ("x", "u", "d", "J", "max_defect"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("case", range(6))
def test_line_search_matches_reference(case):
    rng = np.random.default_rng(case)
    kw = dict(num_time_steps=N, m_blocks_b=4, m_blocks_f=2, num_alpha=A,
              alpha_best_switch=case % 2 == 0, use_exp_red=case != 3)
    cfg_ref = RefConfig(**kw)
    prevJ = np.float32(10.0)
    J = (prevJ - rng.normal(0.2, 0.5, A)).astype(np.float32)
    max_defect = rng.uniform(0.0, 2.0, A).astype(np.float32)
    al = np.power(np.float32(0.5), np.arange(A, dtype=np.float32))
    dJexp = np.asarray([-1.0, 0.4], np.float32) * rng.uniform(0.2, 1.5)
    ignore = bool(case == 4)
    want = ref.line_search(cfg_ref, jnp.asarray(J), jnp.asarray(max_defect), jnp.asarray(al),
                           jnp.asarray(dJexp), jnp.asarray(prevJ), jnp.asarray(ignore))
    got = forward.line_search(interop.solver_config(cfg_ref), torch.as_tensor(J),
                              torch.as_tensor(max_defect), torch.as_tensor(al),
                              torch.as_tensor(dJexp), torch.tensor(prevJ), torch.tensor(ignore))
    for name in want._fields:
        np.testing.assert_allclose(np.asarray(getattr(got, name)), np.asarray(getattr(want, name)),
                                   rtol=1e-6, err_msg=name)
