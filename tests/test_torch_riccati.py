"""The port's backward pass (parallel_ddp_tpu_torch/parallel/backward.py), with
and without the fused Riccati op (ops/cuda_riccati.py, its plain version on
CPU tensors), against the reference's backward pass on the same seeded
inputs (mirrors tests/test_pallas_riccati.py::test_pallas_backward_matches_xla).

Same recursion, Tassa state-reg asymmetry, defect coupling, terminal
pass-through and PD test; the matmuls sum in another order, so allclose."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_ddp_tpu.config import SolverConfig as RefConfig
from parallel_ddp_tpu.parallel.backward import backward_pass as ref_backward_pass
from parallel_ddp_tpu_torch import interop
from parallel_ddp_tpu_torch.ops import cuda_riccati
from parallel_ddp_tpu_torch.parallel.backward import backward_pass

FIELDS = ("P", "p", "K", "du", "ApBK", "Bdu", "dJexp")


def _synthetic(N, n, m, seed=0, indefinite=False):
    """tests/test_pallas_riccati.py::_synthetic; `indefinite` makes the
    u-block of H strongly negative so the first rho attempts fail."""
    rng = np.random.default_rng(seed)
    nm = n + m
    f32 = np.float32
    AB = rng.normal(0, 0.3, (N - 1, n, nm)).astype(f32)
    C = rng.normal(0, 0.3, (N, nm, nm)).astype(f32)
    H = np.einsum("kij,klj->kil", C, C) + np.eye(nm, dtype=f32)
    if indefinite:
        H[:, n:, n:] -= 3.0 * np.eye(m, dtype=f32)
    g = rng.normal(0, 0.5, (N, nm)).astype(f32)
    Cp = rng.normal(0, 0.3, (N, n, n)).astype(f32)
    Pp = np.einsum("kij,klj->kil", Cp, Cp) + np.eye(n, dtype=f32)
    pp = rng.normal(0, 0.5, (N, n)).astype(f32)
    d = rng.normal(0, 0.1, (N, n)).astype(f32)
    x = rng.normal(0, 0.5, (N, n)).astype(f32)
    xp2 = x + rng.normal(0, 0.05, (N, n)).astype(f32)
    return (AB, H, g, Pp, pp, d, x, xp2)


@functools.lru_cache(maxsize=None)
def _reference(state_reg, m_blocks_f, pallas, n, m, N, rho, indefinite=False):
    cfg = RefConfig(num_time_steps=N, total_time=0.5, m_blocks_b=4,
                    m_blocks_f=m_blocks_f, num_alpha=4, state_reg=state_reg,
                    pallas_riccati=pallas)
    args = _synthetic(N, n, m, indefinite=indefinite)
    out = ref_backward_pass(cfg, *(jnp.asarray(a) for a in args),
                            jnp.asarray(rho, jnp.float32), jnp.asarray(1.0, jnp.float32))
    return cfg, args, out


def _port(cfg_ref, args, pallas, rho):
    cfg = dataclasses.replace(interop.solver_config(cfg_ref), pallas_riccati=pallas)
    t = [torch.as_tensor(a) for a in args]
    return backward_pass(cfg, *t, torch.tensor(rho), torch.tensor(1.0))


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("m_blocks_f", [1, 2])
@pytest.mark.parametrize("state_reg", [True, False])
def test_backward_matches_reference_kernel(state_reg, m_blocks_f, pallas):
    """n=3, m=2 against the reference's fused Pallas sweep (interpret mode)."""
    cfg_ref, args, ref = _reference(state_reg, m_blocks_f, True, 3, 2, 16, 1.0)
    out = _port(cfg_ref, args, pallas, 1.0)
    assert not bool(ref.fail) and not bool(out.fail)
    for name in FIELDS:
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=2e-4, atol=2e-5, err_msg=name)
    assert out.host_syncs == 1


@pytest.mark.parametrize("pallas", [False, True])
def test_backward_kuka_size_matches_reference(pallas):
    """n=14, m=7 (the Kuka's sizes) against the reference's XLA scan path."""
    cfg_ref, args, ref = _reference(True, 4, False, 14, 7, 64, 12.5)
    out = _port(cfg_ref, args, pallas, 12.5)
    assert not bool(ref.fail) and not bool(out.fail)
    for name in FIELDS:
        a, b = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        # 14x21 products summed in another order over 16 dependent steps
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4 * max(np.abs(b).max(), 1.0),
                                   err_msg=name)


@pytest.mark.parametrize("pallas", [False, True])
def test_rho_retry_matches_reference(pallas):
    """An indefinite Huu fails the Cholesky test: both packages raise rho by
    the same schedule until it passes, and land on the same result."""
    cfg_ref, args, ref = _reference(True, 2, False, 3, 2, 16, 0.1, indefinite=True)
    out = _port(cfg_ref, args, pallas, 0.1)
    assert not bool(ref.fail) and not bool(out.fail)
    assert float(ref.rho) > 0.1
    np.testing.assert_allclose(float(out.rho), float(ref.rho), rtol=1e-6)
    np.testing.assert_allclose(float(out.drho), float(ref.drho), rtol=1e-6)
    assert out.host_syncs > 1
    for name in FIELDS:
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=2e-4, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("n,m", [(14, 7), (4, 2)], ids=["kuka", "small"])
def test_fused_op_rho_per_lane_and_scalar_agree(n, m):
    """The fused op takes rho as one value or one per lane (the kernel reads
    either); equal values give equal results, and unequal ones act per lane."""
    N, Mb = 16, 4
    cfg = dataclasses.replace(interop.solver_config(RefConfig(
        num_time_steps=N, m_blocks_b=Mb, m_blocks_f=2, num_alpha=4)), pallas_riccati=True)
    AB, H, g, Pp, pp, d, _, _ = (torch.as_tensor(a) for a in _synthetic(N, n, m, seed=3))
    Nb, nm = N // Mb, n + m
    AB_blk = torch.cat([AB, torch.zeros(1, n, nm)]).reshape(Mb, Nb, n, nm)
    args = (Pp[Nb:N:Nb].clone(), pp[Nb:N:Nb].clone())
    seeds_P = torch.cat([args[0], H[N - 1, :n, :n][None]])
    seeds_p = torch.cat([args[1], g[N - 1, :n][None]])
    rest = (seeds_P, seeds_p, AB_blk, H.reshape(Mb, Nb, nm, nm), g.reshape(Mb, Nb, nm),
            d.reshape(Mb, Nb, n))
    bp = cuda_riccati.make_riccati_block_call(cfg, n, m)
    k64 = torch.arange(N).reshape(Mb, Nb)
    one = bp(torch.tensor(0.7), *rest, k64)
    per_lane = bp(torch.full((Mb,), 0.7), *rest, k64.to(torch.int32))
    for a, b in zip(one, per_lane):
        assert torch.equal(a, b)
    assert one[0].shape == (N, n, n) and one[6].shape == (2,) and one[7].dtype == torch.bool
    mixed = bp(torch.tensor([0.7, 0.7, 5.0, 0.7]), *rest, k64)
    lane = lambda t, b: t.reshape((Mb, Nb) + t.shape[1:])[b]
    for field in range(6):
        assert torch.equal(lane(mixed[field], 0), lane(one[field], 0))
        assert not torch.equal(lane(mixed[field], 2), lane(one[field], 2))


def test_fused_op_refuses_what_it_cannot_take():
    cfg = interop.solver_config(RefConfig(num_time_steps=16, m_blocks_b=4))
    with pytest.raises(ValueError):
        cuda_riccati.make_riccati_block_call(cfg, 17, 2)          # past the smem sizing
    bp = cuda_riccati.make_riccati_block_call(cfg, 3, 2)
    args = [torch.zeros(s, device="meta") for s in
            [(), (4, 3, 3), (4, 3), (4, 4, 3, 5), (4, 4, 5, 5), (4, 4, 5), (4, 4, 3)]]
    with pytest.raises(ValueError, match="CUDA"):
        bp(*args, torch.zeros((4, 4), dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):                 # rho per lane
        bp(torch.zeros(4, device="meta"), *args[1:],
           torch.zeros((4, 4), dtype=torch.int32, device="meta"))
    assert cuda_riccati.riccati_cuda.counter.launches == 0
