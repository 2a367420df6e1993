"""The port's CUDA kernels on the card (marker `gpu`: skipped where
torch.cuda.is_available() is False, as on a CPU-only machine).

Run on a GPU machine with:
    python -m pytest --noconftest tests/test_torch_cuda.py -q
(--noconftest: tests/conftest.py sets up JAX, which this file does not use).

Each kernel against its plain version on the same CUDA tensors, the launch
counters, and the solver's TF32 guard.  Tolerances: the kernels evaluate the
plain versions' formulas with fused multiply-adds and another summation
order (see chip_smoke.py, which runs the same checks at the main path's
shapes)."""

import dataclasses

import numpy as np
import pytest
import torch

from parallel_ddp_tpu_torch.ops import cuda_rbd, cuda_riccati, cuda_rollout

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda:0")


def _f32(rng, shape, scale, dev):
    return torch.as_tensor(rng.normal(0, scale, shape).astype(np.float32), device=dev)


def test_rbd_jac_kernel(dev):
    rng = np.random.default_rng(0)
    x, u = _f32(rng, (37, 14), 0.5, dev), _f32(rng, (37, 7), 2.0, dev)
    before = cuda_rbd.kuka_jac_qdd_cuda.launches
    jac, qdd = cuda_rbd.kuka_jac_qdd(x, u, 1, 9.81)
    assert cuda_rbd.kuka_jac_qdd_cuda.launches == before + 1
    ref_jac, ref_qdd = cuda_rbd.kuka_jac_qdd_plain(x, u, 1, 9.81)
    scale = float(ref_jac.abs().max())
    torch.testing.assert_close(jac, ref_jac, rtol=1e-3, atol=1e-4 * scale)
    torch.testing.assert_close(qdd, ref_qdd, rtol=1e-4, atol=1e-5 * float(ref_qdd.abs().max()))


@pytest.mark.parametrize("batch", [1, 37, 8192])
def test_qdd_kernel(dev, batch):
    rng = np.random.default_rng(batch)
    x, u = _f32(rng, (batch, 14), 0.5, dev), _f32(rng, (batch, 7), 2.0, dev)
    before = cuda_rbd.kuka_qdd_cuda.launches
    qdd = cuda_rbd.kuka_qdd(x, u, 1, 9.81)
    assert cuda_rbd.kuka_qdd_cuda.launches == before + 1
    ref = cuda_rbd.kuka_qdd_plain(x, u, 1, 9.81)
    torch.testing.assert_close(qdd, ref, rtol=1e-4, atol=1e-5 * float(ref.abs().max()))
    # leading dims, as the plant step on one sample calls it
    one = cuda_rbd.kuka_qdd(x[0], u[0], 1, 9.81)
    assert one.shape == (7,)
    torch.testing.assert_close(one, qdd[0])
    with pytest.raises(RuntimeError, match="torch.func"):
        torch.func.vmap(cuda_rbd.kuka_qdd)(x, u)


@pytest.mark.parametrize("integrator", [1, 2, 3])
def test_rollout_kernel(dev, integrator):
    rng = np.random.default_rng(integrator)
    N, M, A = 16, 2, 3
    args = (_f32(rng, (A, N, 14), 0.3, dev), _f32(rng, (N, 7), 1.0, dev),
            _f32(rng, (N, 7, 14), 0.05, dev), _f32(rng, (N, 7), 0.5, dev),
            _f32(rng, (N, 14), 0.3, dev), torch.tensor([1.0, 0.5, 0.25], device=dev))
    fused = cuda_rollout.make_kuka_fused_rollout(1, 0.0, integrator, 0.01, N, M, A)
    got = fused(*args)
    ref = fused(*[a.cpu() for a in args])
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.cpu(), r, rtol=1e-4, atol=1e-5)


def test_riccati_kernel(dev):
    from parallel_ddp_tpu_torch.config import SolverConfig

    cfg = SolverConfig(num_time_steps=16, m_blocks_b=4, m_blocks_f=2, num_alpha=4)
    rng = np.random.default_rng(7)
    n, m, Mb, Nb = 14, 7, 4, 4
    nm = n + m
    C = rng.normal(0, 0.3, (Mb, Nb, nm, nm))
    H = torch.as_tensor((np.einsum("abij,ablj->abil", C, C) + np.eye(nm)).astype(np.float32),
                        device=dev)
    Cp = rng.normal(0, 0.3, (Mb, n, n))
    sP = torch.as_tensor((np.einsum("aij,alj->ail", Cp, Cp) + np.eye(n)).astype(np.float32),
                         device=dev)
    args = (torch.tensor(0.5, device=dev), sP, _f32(rng, (Mb, n), 0.5, dev),
            _f32(rng, (Mb, Nb, n, nm), 0.3, dev), H, _f32(rng, (Mb, Nb, nm), 0.5, dev),
            _f32(rng, (Mb, Nb, n), 0.1, dev),
            torch.arange(Mb * Nb, device=dev).reshape(Mb, Nb))
    bp = cuda_riccati.make_riccati_block_call(cfg, n, m)
    got = bp(*args)
    ref = bp(*[a.cpu() for a in args])
    assert not bool(got[7]) and not bool(ref[7])
    for g, r in zip(got[:7], ref[:7]):
        torch.testing.assert_close(g.cpu(), r, rtol=1e-4, atol=1e-5 * max(float(r.abs().max()), 1.0))


def test_solver_refuses_tf32(dev):
    from parallel_ddp_tpu_torch.presets import ee_goal, kuka_ee
    from parallel_ddp_tpu_torch.solver import make_ilqr_solver

    prob = kuka_ee(num_time_steps=16, m_blocks=2, num_alpha=4)
    solver = make_ilqr_solver(prob.plant, prob.cost,
                              dataclasses.replace(prob.cfg, max_iter=1, pallas_riccati=True))
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="tf32"):
            solver(torch.zeros(16, 14, device=dev), torch.zeros(16, 7, device=dev),
                   ee_goal([0.3, -0.3, 0.9], device=dev), initial_rollout=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
