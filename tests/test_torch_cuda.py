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

from parallel_ddp_tpu_torch.ops import cuda_rbd, cuda_riccati, cuda_rollout, cuda_sim_chain

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


@pytest.mark.parametrize("batch", [1, 63, 1000])
def test_rbd_jac_group_kernel_batches(dev, batch):
    """The thread-group Jacobian kernel at one sample (a block of one group),
    the main path's 63 and 1,000 (657 blocks, the last one ragged)."""
    rng = np.random.default_rng(batch)
    x, u = _f32(rng, (batch, 14), 0.5, dev), _f32(rng, (batch, 7), 2.0, dev)
    jac, qdd = cuda_rbd.kuka_jac_qdd(x, u, 1, 0.0)
    ref_jac, ref_qdd = cuda_rbd.kuka_jac_qdd_plain(x, u, 1, 0.0)
    assert jac.shape == (batch, 7, 21) and qdd.shape == (batch, 7)
    torch.testing.assert_close(jac, ref_jac, rtol=1e-3, atol=1e-4 * float(ref_jac.abs().max()))
    torch.testing.assert_close(qdd, ref_qdd, rtol=1e-3, atol=1e-4 * float(ref_qdd.abs().max()))


@pytest.mark.parametrize("batch", [1, 63])
def test_euler_ab_epilogue_is_the_composer_bit_for_bit(dev, batch):
    """The AB the kernel writes in its epilogue equals E + dt * F, the
    composer's two tensor operations, on the J of the same kernel: no bit
    differs; and one launch makes it."""
    rng = np.random.default_rng(7 + batch)
    dt = 0.5 / 63
    x, u = _f32(rng, (batch, 14), 0.5, dev), _f32(rng, (batch, 7), 2.0, dev)
    before = cuda_rbd.kuka_jac_qdd_cuda.launches
    ab = cuda_rbd.make_kuka_ab(1, 0.0, 1, dt)(x, u)
    assert cuda_rbd.kuka_jac_qdd_cuda.launches == before + 1
    assert ab.shape == (batch, 14, 21)
    jac, _ = cuda_rbd.kuka_jac_qdd_cuda(x, u, 1, 0.0)

    def lifted(xs, us):
        top = torch.zeros((batch, 7, 21), device=dev)
        top[:, :, 7:14] = torch.eye(7, device=dev)
        return torch.cat([top, jac], dim=1)

    composed = cuda_rbd.make_ab_composer(None, lifted, 1, dt, 14, 7)(x, u)
    assert torch.equal(ab, composed)
    # Midpoint and RK3 still go through the composer, one launch a stage
    before = cuda_rbd.kuka_jac_qdd_cuda.launches
    ab3 = cuda_rbd.make_kuka_ab(1, 0.0, 3, dt)(x, u)
    assert cuda_rbd.kuka_jac_qdd_cuda.launches == before + 3 and ab3.shape == (batch, 14, 21)


def _rollout_inputs(rng, A, M, nf, dev):
    N = M * nf
    alphas = torch.as_tensor((0.5 ** np.arange(A)).astype(np.float32), device=dev)
    return (_f32(rng, (A, N, 14), 0.3, dev), _f32(rng, (N, 7), 1.0, dev),
            _f32(rng, (N, 7, 14), 0.05, dev), _f32(rng, (N, 7), 0.5, dev),
            _f32(rng, (N, 14), 0.3, dev), alphas)


@pytest.mark.parametrize("integrator", [1, 3])
@pytest.mark.parametrize("nf", [16, 7])
@pytest.mark.parametrize("A,M", [(16, 4), (1, 1), (5, 3), (40, 2)])
def test_rollout_group_kernel_lanes(dev, A, M, nf, integrator):
    """The thread-group rollout kernel at the main path's 16 x 4 lanes, one
    lane, ragged 5 x 3 and 40 alphas (two chunks of lanes a shooting block),
    with the default mask and with one that skips an interior step too."""
    rng = np.random.default_rng(100 * A + 10 * M + nf + integrator)
    args = _rollout_inputs(rng, A, M, nf, dev)
    fused = cuda_rollout.make_kuka_fused_rollout(1, 0.0, integrator, 0.5 / 63, M * nf, M, A)
    mask = torch.zeros((M, nf), dtype=torch.bool)
    mask[-1, -1] = True
    mask[0, nf // 2] = True
    before = cuda_rollout.kuka_rollout_cuda.launches
    for skip in (None, mask):
        got = fused(*args, skip_mask=None if skip is None else skip.to(dev))
        ref = fused(*[a.cpu() for a in args], skip_mask=skip)
        assert got[0].shape == (A, M, nf, 14) and got[1].shape == (A, M, nf, 7)
        for g, r in zip(got, ref):
            torch.testing.assert_close(g.cpu(), r, rtol=1e-4, atol=1e-5 * max(float(r.abs().max()), 1.0))
    assert cuda_rollout.kuka_rollout_cuda.launches == before + 2


@pytest.mark.parametrize("integrator", [1, 2, 3])
def test_rollout_without_feedback_is_the_chain_kernel(dev, integrator):
    """With K = 0 and du = 0 a rollout lane is an open-loop chain: the
    thread-group kernel and the one-thread chain kernel run the same dynamics
    and agree to rounding (where nvcc fuses a multiply-add)."""
    rng = np.random.default_rng(integrator)
    A, M, nf = 3, 2, 9
    x_sw, u, K, du, xp, alphas = _rollout_inputs(rng, A, M, nf, dev)
    dt = 0.5 / 63
    fused = cuda_rollout.make_kuka_fused_rollout(1, 0.0, integrator, dt, M * nf, M, A)
    none = torch.zeros((M, nf), dtype=torch.bool, device=dev)
    x_roll, u_roll = fused(x_sw, u, torch.zeros_like(K), torch.zeros_like(du), xp, alphas,
                           skip_mask=none)
    chain = cuda_sim_chain.make_kuka_sim_chain(1, 0.0, integrator, dt)
    x0 = x_sw.reshape(A, M, nf, 14)[:, :, 0]
    u_lanes = u.reshape(M, nf, 7).expand(A, M, nf, 7).contiguous()
    x_chain = chain.open_loop(x0, u_lanes)
    assert torch.equal(u_roll, u_lanes)
    torch.testing.assert_close(x_roll, x_chain, rtol=1e-5,
                               atol=2e-6 * max(float(x_chain.abs().max()), 1.0))


@pytest.mark.parametrize("integrator,lead,steps", [(1, (), 63), (1, (4,), 16), (2, (2, 3), 5),
                                                   (3, (), 15)])
def test_sim_chain_open_loop_kernel(dev, integrator, lead, steps):
    """Mode (a) against the step repeated in a Python loop (the plain
    version), on the same CUDA tensors: rounding compounds over the steps
    (measured 4.6e-6 at 63 Euler steps on an H100)."""
    rng = np.random.default_rng(steps)
    dt = 0.5 / 63
    x0, u = _f32(rng, lead + (14,), 0.3, dev), _f32(rng, lead + (steps, 7), 1.0, dev)
    chain = cuda_sim_chain.make_kuka_sim_chain(1, 0.0, integrator, dt)
    before = cuda_sim_chain.kuka_open_loop_cuda.launches
    got = chain.open_loop(x0, u)
    assert cuda_sim_chain.kuka_open_loop_cuda.launches == before + 1
    assert got.shape == lead + (steps, 14)
    ref = chain.open_loop(x0.cpu(), u.cpu())
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-5, atol=2e-6 * max(float(ref.abs().max()), 1.0))
    # a non-contiguous control slice, as the MPC warm start passes it
    wide = torch.cat([u, u], dim=-1)
    torch.testing.assert_close(chain.open_loop(x0, wide[..., :7]), got, rtol=0, atol=0)


@pytest.mark.parametrize("t0,t,feedback", [(0.25, 0.2617, True), (0.25, 0.2617, False),
                                           (0.0, 0.4995, True), (0.3, 0.1, True)])
def test_sim_chain_runner_kernel(dev, t0, t, feedback):
    """Mode (b) against control law + step in a Python loop: inside the
    plan, without feedback, and clamped at the plan's end and start."""
    rng = np.random.default_rng(5)
    n_traj, dt, sim_dt = 64, 0.5 / 63, 0.001
    plan = (_f32(rng, (n_traj, 14), 0.3, dev), _f32(rng, (n_traj, 7), 1.0, dev),
            _f32(rng, (n_traj, 7, 14), 0.05, dev))
    x = _f32(rng, (14,), 0.3, dev)
    clocks = torch.tensor(t0, device=dev), torch.tensor(t, device=dev)
    chain = cuda_sim_chain.make_kuka_sim_chain(1, 0.0, 1, sim_dt)
    before = cuda_sim_chain.kuka_runner_cuda.launches
    got_x, got_t = chain.runner(*plan, clocks[0], dt, clocks[1], x, 10, feedback)
    assert cuda_sim_chain.kuka_runner_cuda.launches == before + 1
    ref_x, ref_t = chain.runner(*(a.cpu() for a in plan), clocks[0].cpu(), dt, clocks[1].cpu(),
                                x.cpu(), 10, feedback)
    assert got_x.shape == (10, 14) and got_t.dim() == 0 and got_t.device == dev
    torch.testing.assert_close(got_x.cpu(), ref_x, rtol=1e-5, atol=2e-6)
    torch.testing.assert_close(got_t.cpu(), ref_t, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="CUDA"):      # a CPU tensor among CUDA ones
        chain.runner(plan[0], plan[1].cpu(), plan[2], clocks[0], dt, clocks[1], x, 10, feedback)


@pytest.mark.parametrize("n,m,lanes,steps,rho_lane", [
    (14, 7, 4, 16, False),    # the compile-time-size body, every step staged
    (14, 7, 2, 96, True),     # a block longer than its ring (73 slots): the slots
                              # of finished steps are refilled; rho per lane
    (4, 2, 4, 4, False),      # the run-time-size body
    (16, 8, 2, 64, True),     # the largest sizes it takes, ring (56 slots) refilled
])
def test_riccati_kernel_bodies_and_ring(dev, n, m, lanes, steps, rho_lane):
    from parallel_ddp_tpu_torch.config import SolverConfig

    Mb, Nb, nm = lanes, steps, n + m
    N = Mb * Nb
    cfg = SolverConfig(num_time_steps=N, m_blocks_b=Mb, m_blocks_f=2, num_alpha=4)
    rng = np.random.default_rng(n + steps)
    C = rng.normal(0, 0.3, (Mb, Nb, nm, nm))
    H = torch.as_tensor((np.einsum("abij,ablj->abil", C, C) + np.eye(nm)).astype(np.float32),
                        device=dev)
    Cp = rng.normal(0, 0.3, (Mb, n, n))
    sP = torch.as_tensor((np.einsum("aij,alj->ail", Cp, Cp) + np.eye(n)).astype(np.float32),
                         device=dev)
    rho = (torch.as_tensor(rng.uniform(0.2, 2.0, Mb).astype(np.float32), device=dev) if rho_lane
           else torch.tensor(0.5, device=dev))
    args = (rho, sP, _f32(rng, (Mb, n), 0.5, dev), _f32(rng, (Mb, Nb, n, nm), 0.3, dev), H,
            _f32(rng, (Mb, Nb, nm), 0.5, dev), _f32(rng, (Mb, Nb, n), 0.1, dev),
            torch.arange(N, device=dev).reshape(Mb, Nb))
    before = cuda_riccati.riccati_cuda.launches
    got = cuda_riccati.riccati_cuda(*args, nf=N - 1, n_blocks_f=cfg.n_blocks_f,
                                    state_reg=cfg.state_reg, use_defect=True)
    assert cuda_riccati.riccati_cuda.launches == before + 1
    ref = cuda_riccati.make_riccati_block_call(cfg, n, m)(*[a.cpu() for a in args])
    assert not bool(got[7]) and not bool(ref[7]) and got[7].dtype == torch.bool
    for g, r in zip(got[:7], ref[:7]):
        torch.testing.assert_close(g.cpu(), r, rtol=1e-4, atol=1e-5 * max(float(r.abs().max()), 1.0))
    # an indefinite Huu raises the fail flag, as in the plain version
    bad = list(args)
    bad[4] = H.clone()
    bad[4][..., n:, n:] -= 50.0 * torch.eye(m, device=dev)
    got_bad = cuda_riccati.riccati_cuda(*bad, nf=N - 1, n_blocks_f=cfg.n_blocks_f,
                                        state_reg=cfg.state_reg, use_defect=True)
    ref_bad = cuda_riccati.make_riccati_block_call(cfg, n, m)(*[a.cpu() for a in bad])
    assert bool(got_bad[7]) and bool(ref_bad[7])


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
