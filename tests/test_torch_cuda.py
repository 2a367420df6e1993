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
    before = cuda_rbd.kuka_jac_qdd_cuda.counter.launches
    jac, qdd = cuda_rbd.kuka_jac_qdd(x, u, 1, 9.81)
    assert cuda_rbd.kuka_jac_qdd_cuda.counter.launches == before + 1
    ref_jac, ref_qdd = cuda_rbd.kuka_jac_qdd_plain(x, u, 1, 9.81)
    scale = float(ref_jac.abs().max())
    torch.testing.assert_close(jac, ref_jac, rtol=1e-3, atol=1e-4 * scale)
    torch.testing.assert_close(qdd, ref_qdd, rtol=1e-4, atol=1e-5 * float(ref_qdd.abs().max()))


@pytest.mark.parametrize("batch", [1, 33, 37, 2 * 21 * 63, 8192])
def test_qdd_kernel(dev, batch):
    rng = np.random.default_rng(batch)
    x, u = _f32(rng, (batch, 14), 0.5, dev), _f32(rng, (batch, 7), 2.0, dev)
    before = cuda_rbd.kuka_qdd_cuda.counter.launches
    qdd = cuda_rbd.kuka_qdd(x, u, 1, 9.81)
    assert cuda_rbd.kuka_qdd_cuda.counter.launches == before + 1
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


@pytest.mark.parametrize("batch", [1, 63, 1000, 256 * 63, 4096 * 63])
def test_rbd_jac_group_kernel_batches(dev, batch):
    """The thread-group Jacobian kernel at one sample (a block of one group),
    the main path's 63, 1,000 (657 blocks, the last one ragged) and the
    batched solve's flattened B x 63 at B = 256 and 4096."""
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
    before = cuda_rbd.kuka_jac_qdd_cuda.counter.launches
    ab = cuda_rbd.make_kuka_ab(1, 0.0, 1, dt)(x, u)
    assert cuda_rbd.kuka_jac_qdd_cuda.counter.launches == before + 1
    assert ab.shape == (batch, 14, 21)
    jac, _ = cuda_rbd.kuka_jac_qdd_cuda(x, u, 1, 0.0)

    def lifted(xs, us):
        top = torch.zeros((batch, 7, 21), device=dev)
        top[:, :, 7:14] = torch.eye(7, device=dev)
        return torch.cat([top, jac], dim=1)

    composed = cuda_rbd.make_ab_composer(None, lifted, 1, dt, 14, 7)(x, u)
    assert torch.equal(ab, composed)
    # Midpoint and RK3 still go through the composer, one launch a stage
    before = cuda_rbd.kuka_jac_qdd_cuda.counter.launches
    ab3 = cuda_rbd.make_kuka_ab(1, 0.0, 3, dt)(x, u)
    assert cuda_rbd.kuka_jac_qdd_cuda.counter.launches == before + 3 and ab3.shape == (batch, 14, 21)


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
    before = cuda_rollout.kuka_rollout_cuda.counter.launches
    for skip in (None, mask):
        got = fused(*args, skip_mask=None if skip is None else skip.to(dev))
        ref = fused(*[a.cpu() for a in args], skip_mask=skip)
        assert got[0].shape == (A, M, nf, 14) and got[1].shape == (A, M, nf, 7)
        for g, r in zip(got, ref):
            torch.testing.assert_close(g.cpu(), r, rtol=1e-4, atol=1e-5 * max(float(r.abs().max()), 1.0))
    assert cuda_rollout.kuka_rollout_cuda.counter.launches == before + 2


# the bfloat16 step: its kernel and plain version round every operation to
# bfloat16 alike (tests/test_torch_group_core.py holds the dynamics bit for
# bit on the host); they part only where the float32 feedback law's sums
# round otherwise, by float32 roundings, unless a control lands on the other
# side of a bfloat16 rounding, which the steps then carry.  At these few
# lanes the limit is chip_smoke.py's for the WAFR shape: 1e-5 of
# max(|x|, 1), at least 90 % of the outputs bit for bit, and rollout.cu's
# float32 result outside the limit on the same inputs (the limit separates
# the two precisions)
BF16_LIMIT = 1e-5
BF16_SAME_MIN = 0.9


def _default_skip(M, nf, dev):
    k = torch.arange(M * nf, device=dev).reshape(M, nf)
    return (k == M * nf - 1).to(torch.uint8)


@pytest.mark.parametrize("integrator", [1, 2, 3])
@pytest.mark.parametrize("A,M,nf", [(16, 4, 16), (5, 3, 7), (40, 2, 16)])
def test_rollout_bf16_kernel(dev, A, M, nf, integrator):
    """The rollout kernel's bfloat16 entry against its plain version on the
    same CUDA tensors (the soa step on bfloat16 tensors), with the default
    mask and one that skips an interior step, within BF16_LIMIT, which the
    float32 kernel misses; its own launch counter counts, the float32
    rollout's only for the calls made here."""
    rng = np.random.default_rng(200 * A + 10 * M + nf + integrator)
    args = _rollout_inputs(rng, A, M, nf, dev)
    fused = cuda_rollout.make_kuka_bf16_rollout(1, 0.0, integrator, 0.5 / 63, M * nf, M, A)
    mask = _default_skip(M, nf, dev)
    mask[0, nf // 2] = 1
    kw = dict(ee_type=1, gravity=0.0, integrator=integrator, dt=0.5 / 63, m_blocks=M)
    before = (cuda_rollout.kuka_rollout_bf16_cuda.counter.launches,
              cuda_rollout.kuka_rollout_cuda.counter.launches)
    rel = lambda got, ref: max(float((g - r).abs().max()) / max(float(r.abs().max()), 1.0)
                               for g, r in zip(got, ref))
    for skip in (_default_skip(M, nf, dev), mask):
        got = fused(*args, skip_mask=skip)
        ref = cuda_rollout.kuka_rollout_bf16_plain(*args, skip, **kw)
        assert got[0].dtype == torch.float32 and got[0].shape == (A, M, nf, 14)
        same = sum(int((g == r).sum()) for g, r in zip(got, ref)) / sum(g.numel() for g in got)
        err = rel(got, ref)
        assert err <= BF16_LIMIT and same >= BF16_SAME_MIN, (err, same)
        sep = rel(cuda_rollout.kuka_rollout_cuda(*args, skip, **kw), ref)
        assert sep > BF16_LIMIT, sep
    # the float32 kernel ran only where called above, for the separation
    assert cuda_rollout.kuka_rollout_bf16_cuda.counter.launches == before[0] + 2
    assert cuda_rollout.kuka_rollout_cuda.counter.launches == before[1] + 2


def test_rollout_bf16_kernel_scenarios(dev):
    """S = 3 scenarios in one launch of the bfloat16 entry: each scenario's
    outputs are its own launch's, bit for bit."""
    rng = np.random.default_rng(11)
    A, M, nf = 16, 4, 16
    batch = [_rollout_inputs(rng, A, M, nf, dev) for _ in range(3)]
    alphas = batch[0][5]
    fused = cuda_rollout.make_kuka_bf16_rollout(1, 0.0, 1, 0.5 / 63, M * nf, M, A)
    xs, us = fused(*[torch.stack([b[i] for b in batch]) for i in range(5)], alphas)
    for s, b in enumerate(batch):
        x1, u1 = fused(*b[:5], alphas)
        assert torch.equal(xs[s], x1) and torch.equal(us[s], u1)


def test_qdd_kernel_refuses_bf16(dev):
    """No path runs a bfloat16 step through the float32 forward-dynamics
    kernel: it refuses bfloat16 input."""
    x = torch.zeros(4, 14, device=dev, dtype=torch.bfloat16)
    u = torch.zeros(4, 7, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        cuda_rbd.kuka_qdd_cuda(x, u, 1, 0.0)


@pytest.mark.parametrize("integrator", [1, 2, 3])
def test_rollout_without_feedback_is_the_chain_kernel(dev, integrator):
    """With K = 0 and du = 0 a rollout lane is an open-loop chain: the rollout
    kernel and the chain kernel run the same dynamics and agree to rounding
    (both on the thread-group core since the chain moved onto it: the case
    below holds them bit for bit)."""
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


@pytest.mark.parametrize("ahead", [True, False], ids=["ahead", "in_step"])
@pytest.mark.parametrize("integrator", [1, 2, 3])
def test_rollout_without_feedback_equals_the_chain_kernel_bit_for_bit(dev, integrator, ahead):
    """Both kernels run the group core (kuka_soa_group.cuh), and with K = 0 and
    du = 0 a rollout lane's control is u itself: the rollout kernel and the
    chain kernel, on either schedule, compute the same states bit for bit."""
    rng = np.random.default_rng(integrator)
    A, M, nf = 3, 2, 9
    x_sw, u, K, du, xp, alphas = _rollout_inputs(rng, A, M, nf, dev)
    dt = 0.5 / 63
    fused = cuda_rollout.make_kuka_fused_rollout(1, 0.0, integrator, dt, M * nf, M, A)
    none = torch.zeros((M, nf), dtype=torch.bool, device=dev)
    x_roll, _ = fused(x_sw, u, torch.zeros_like(K), torch.zeros_like(du), xp, alphas,
                      skip_mask=none)
    x0 = x_sw.reshape(A, M, nf, 14)[:, :, 0]
    u_lanes = u.reshape(M, nf, 7).expand(A, M, nf, 7).contiguous()
    x_chain = cuda_sim_chain.kuka_open_loop_cuda(x0, u_lanes, ee_type=1, gravity=0.0,
                                                 integrator=integrator, dt=dt, ahead=ahead)
    assert torch.equal(x_roll, x_chain)


@pytest.mark.parametrize("integrator,lead,steps", [(1, (), 63), (1, (4,), 16), (2, (2, 3), 5),
                                                   (3, (), 15), (1, (256, 4), 16), (1, (256,), 63),
                                                   (1, (33,), 16), (1, (1024,), 16)])
def test_sim_chain_open_loop_kernel(dev, integrator, lead, steps):
    """Mode (a) against the step repeated in a Python loop (the plain
    version), on CPU tensors: rounding compounds over the steps (measured
    4.6e-6 at 63 Euler steps on an H100).  Also at the batched solve's
    initial rollout (B x 4 blocks of 16 steps) and the fleet step's warm
    start (B chains of 63 steps), B = 256; at 33 chains, which leave 31
    lanes of the second block idle (they run copies of the last chain and
    write nothing), and at the batched cold rollout's 1,024."""
    rng = np.random.default_rng(steps)
    dt = 0.5 / 63
    x0, u = _f32(rng, lead + (14,), 0.3, dev), _f32(rng, lead + (steps, 7), 1.0, dev)
    chain = cuda_sim_chain.make_kuka_sim_chain(1, 0.0, integrator, dt)
    before = cuda_sim_chain.kuka_open_loop_cuda.counter.launches
    got = chain.open_loop(x0, u)
    assert cuda_sim_chain.kuka_open_loop_cuda.counter.launches == before + 1
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
    before = cuda_sim_chain.kuka_runner_cuda.counter.launches
    got_x, got_t = chain.runner(*plan, clocks[0], dt, clocks[1], x, 10, feedback)
    assert cuda_sim_chain.kuka_runner_cuda.counter.launches == before + 1
    ref_x, ref_t = chain.runner(*(a.cpu() for a in plan), clocks[0].cpu(), dt, clocks[1].cpu(),
                                x.cpu(), 10, feedback)
    assert got_x.shape == (10, 14) and got_t.dim() == 0 and got_t.device == dev
    torch.testing.assert_close(got_x.cpu(), ref_x, rtol=1e-5, atol=2e-6)
    torch.testing.assert_close(got_t.cpu(), ref_t, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="CUDA"):      # a CPU tensor among CUDA ones
        chain.runner(plan[0], plan[1].cpu(), plan[2], clocks[0], dt, clocks[1], x, 10, feedback)


@pytest.mark.parametrize("batch", [1, 256])
def test_sim_chain_ahead_equals_in_step_bit_for_bit(dev, batch):
    """The Euler chain with each step's mass matrix and factor made a step
    ahead (what the wrappers launch) against the same chain on the in-step
    schedule: the same expressions on the same operands, bit for bit, at the
    warm start's T = 63 (B = 1 and the fleet's B = 256) and in runner mode."""
    rng = np.random.default_rng(60 + batch)
    dt = 0.5 / 63
    x0, u = _f32(rng, (batch, 14), 0.3, dev), _f32(rng, (batch, 63, 7), 1.0, dev)
    kw = dict(ee_type=1, gravity=0.0, integrator=1, dt=dt)
    ahead = cuda_sim_chain.kuka_open_loop_cuda(x0, u, **kw)
    in_step = cuda_sim_chain.kuka_open_loop_cuda(x0, u, ahead=False, **kw)
    assert torch.equal(ahead, in_step)
    plan = (_f32(rng, (64, 14), 0.3, dev), _f32(rng, (64, 7), 1.0, dev),
            _f32(rng, (64, 7, 14), 0.05, dev))
    args = (*plan, torch.tensor(0.25, device=dev), dt, torch.tensor(0.2617, device=dev), x0[0],
            63)
    kw = dict(ee_type=1, gravity=0.0, integrator=1, sim_dt=0.001)
    for got, ref in zip(cuda_sim_chain.kuka_runner_cuda(*args, **kw),
                        cuda_sim_chain.kuka_runner_cuda(*args, ahead=False, **kw)):
        assert torch.equal(got, ref)


@pytest.mark.parametrize("n,m,lanes,steps,rho_lane", [
    (14, 7, 4, 16, False),    # the compile-time-size body, every step staged
    (14, 7, 2, 96, True),     # a block longer than its ring (73 slots): the slots
                              # of finished steps are refilled; rho per lane
    (4, 2, 4, 4, False),      # the run-time-size body
    (16, 8, 2, 64, True),     # the largest sizes it takes, ring (56 slots) refilled
    (2, 1, 4, 32, False),     # the pendulum's, cart-pole's and quadrotor's
    (4, 1, 4, 32, True),      # (N = 128, 4 blocks), one warp's Cholesky at
    (12, 4, 4, 32, False),    # m = 1 and m = 4
    (12, 4, 4, 16, True),     # the quadrotor at N = 64 (its JAX test's size)
    (2, 1, 2, 16, False),     # the pendulum's MPC loop (N = 32, 2 blocks)
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
    before = cuda_riccati.riccati_cuda.counter.launches
    got = cuda_riccati.riccati_cuda(*args, nf=N - 1, n_blocks_f=cfg.n_blocks_f,
                                    state_reg=cfg.state_reg, use_defect=True)
    assert cuda_riccati.riccati_cuda.counter.launches == before + 1
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


GRAVITY = 9.81


@pytest.mark.parametrize("integrator", [1, 3])
def test_kuka_kernels_with_gravity(dev, integrator):
    """kuka_joint's arm has gravity on: the Jacobian kernel (and its Euler AB
    epilogue), the rollout kernel and the chain kernel's open loop at
    g = 9.81 against their plain versions (the tolerances of the g = 0 tests
    above)."""
    rng = np.random.default_rng(40 + integrator)
    dt = 0.5 / 63
    x, u = _f32(rng, (63, 14), 0.5, dev), _f32(rng, (63, 7), 2.0, dev)
    jac, qdd = cuda_rbd.kuka_jac_qdd(x, u, 1, GRAVITY)
    ref_jac, ref_qdd = cuda_rbd.kuka_jac_qdd_plain(x, u, 1, GRAVITY)
    torch.testing.assert_close(jac, ref_jac, rtol=1e-3, atol=1e-4 * float(ref_jac.abs().max()))
    torch.testing.assert_close(qdd, ref_qdd, rtol=1e-3, atol=1e-4 * float(ref_qdd.abs().max()))
    ab = cuda_rbd.make_kuka_ab(1, GRAVITY, integrator, dt)(x, u)
    ref_ab = cuda_rbd.make_kuka_ab(1, GRAVITY, integrator, dt)(x.cpu(), u.cpu())
    torch.testing.assert_close(ab.cpu(), ref_ab, rtol=1e-3, atol=1e-4 * float(ref_ab.abs().max()))
    A, M, nf = 16, 4, 16
    args = _rollout_inputs(rng, A, M, nf, dev)
    fused = cuda_rollout.make_kuka_fused_rollout(1, GRAVITY, integrator, dt, M * nf, M, A)
    for g, r in zip(fused(*args), fused(*[a.cpu() for a in args])):
        torch.testing.assert_close(g.cpu(), r, rtol=1e-4, atol=1e-5 * max(float(r.abs().max()), 1.0))
    chain = cuda_sim_chain.make_kuka_sim_chain(1, GRAVITY, integrator, dt)
    x0, uc = _f32(rng, (4, 14), 0.3, dev), _f32(rng, (4, 16, 7), 1.0, dev)
    ref = chain.open_loop(x0.cpu(), uc.cpu())
    torch.testing.assert_close(chain.open_loop(x0, uc).cpu(), ref, rtol=1e-5,
                               atol=2e-6 * max(float(ref.abs().max()), 1.0))


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


# --- the graph route: solve, MPC step and closed loop as CUDA-graph replays

def _small_problem(max_iter=6):
    from parallel_ddp_tpu_torch.presets import kuka_ee

    prob = kuka_ee(num_time_steps=16, m_blocks=2, num_alpha=4)
    return prob, dataclasses.replace(prob.cfg, max_iter=max_iter, pallas_riccati=True)


def _assert_same_decisions(gpu, cpu):
    """The same alphas, and J within 1e-3 (float32 rounding of two summation
    orders; chip_smoke.py's SOLVE_RTOL)."""
    it = int(cpu.iters)
    assert int(gpu.iters) == it
    assert torch.equal(gpu.alpha_trace.cpu()[: it + 1], cpu.alpha_trace[: it + 1])
    torch.testing.assert_close(gpu.J_trace.cpu()[: it + 1], cpu.J_trace[: it + 1],
                               rtol=1e-3, atol=0)


def _assert_same_run(graphed, eager):
    """A replay against the same body run eagerly on the card: the same
    kernels on the same inputs, so the same decisions and, but for cuBLAS
    choosing another algorithm under capture, the same numbers (rtol 1e-5)."""
    assert int(graphed.iters) == int(eager.iters)
    assert torch.equal(graphed.alpha_trace, eager.alpha_trace)
    for a, b in zip(graphed, eager):
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, equal_nan=True)


def test_replayed_solve_matches_cpu_and_takes_new_inputs(dev):
    """A cold solve replayed on the card takes the CPU's decisions; warm
    replays with a new goal, iter_limit or cost weights match the same solve
    run eagerly on the card (the body's host loop), each with no new capture
    (the weights are a tensor the graph loads); the launch counters count
    replays."""
    from parallel_ddp_tpu_torch.config import CostWeights
    from parallel_ddp_tpu_torch.presets import ee_goal
    from parallel_ddp_tpu_torch.solver import make_ilqr_solver

    prob, cfg = _small_problem()
    gpu_solver = make_ilqr_solver(prob.plant, prob.cost, cfg)
    cpu_solver = make_ilqr_solver(prob.plant, prob.cost, cfg)
    x0, u0 = torch.zeros(16, 14), torch.zeros(16, 7)
    goals = [ee_goal(g, device=dev) for g in ((0.3, -0.3, 0.9), (0.35, -0.25, 0.85))]
    cold = gpu_solver(x0.to(dev), u0.to(dev), goals[0], initial_rollout=True)
    _assert_same_decisions(cold, cpu_solver(x0, u0, {k: v.cpu() for k, v in goals[0].items()},
                                            initial_rollout=True))
    for goal, limit, w in ((goals[1], None, None), (goals[0], 2, None),
                           (goals[1], None, CostWeights(r_ee=1e-3))):
        gpu = gpu_solver(cold.x, cold.u, goal, w, P0=cold.P, p0=cold.p, d0=cold.d,
                         iter_limit=limit)
        assert gpu_solver.host_syncs == 0
        eager, reads = gpu_solver.run(cold.x, cold.u, goal, cold.P, cold.p, cold.d,
                                      limit or cfg.max_iter, w or CostWeights(), False, False)
        assert reads > 0
        _assert_same_run(gpu, eager)
        assert int(gpu.iters) == (limit or cfg.max_iter)
    assert len(gpu_solver.graphs) == 2                  # cold, warm (new weights: data)
    counters = (cuda_rbd.kuka_jac_qdd_cuda.counter, cuda_rollout.kuka_rollout_cuda.counter,
                cuda_riccati.riccati_cuda.counter)
    for c in counters:
        c.reset()
    out = gpu_solver(cold.x, cold.u, goals[1], P0=cold.P, p0=cold.p, d0=cold.d, iter_limit=3)
    iters = int(out.iters)
    assert iters == 3
    jac, roll, ric = (c.launches for c in counters)
    assert jac == roll == iters and ric >= iters      # one rho attempt or more an iteration


def test_replayed_outputs_are_not_overwritten(dev):
    from parallel_ddp_tpu_torch.presets import ee_goal
    from parallel_ddp_tpu_torch.solver import make_ilqr_solver

    prob, cfg = _small_problem(3)
    solver = make_ilqr_solver(prob.plant, prob.cost, cfg)
    x0, u0 = torch.zeros(16, 14, device=dev), torch.zeros(16, 7, device=dev)
    first = solver(x0, u0, ee_goal((0.3, -0.3, 0.9), device=dev), initial_rollout=True)
    kept = [t.clone() for t in first if isinstance(t, torch.Tensor)]
    second = solver(x0, u0, ee_goal((0.2, 0.3, 0.7), device=dev), initial_rollout=True)
    assert not torch.equal(first.x, second.x)
    for a, b in zip([t for t in first if isinstance(t, torch.Tensor)], kept):
        assert torch.equal(a, b)


def test_replayed_mpc_step_and_loop(dev, monkeypatch):
    """An MPC step and three closed-loop control steps replayed on the card
    match the same steps run eagerly on the card (the host-loop route); the
    MPC step takes the CPU's accept decision with J within 1e-3, the loop the
    CPU's accepts with the EE error within 1e-4 m; under torch's sync debug
    mode "error" a warm solve, an MPC step and ten control steps raise
    nothing."""
    from parallel_ddp_tpu_torch import graphs
    from parallel_ddp_tpu_torch.mpc.device_loop import make_device_mpc_loop
    from parallel_ddp_tpu_torch.mpc.driver import MPCConfig, MPCController, MPCState
    from parallel_ddp_tpu_torch.presets import ee_goal, fig8_weights
    from parallel_ddp_tpu_torch.solver import make_ilqr_solver

    prob, cfg = _small_problem()
    w = fig8_weights()
    x_init = torch.zeros(14)
    x_init[1], x_init[3], x_init[5] = np.pi / 4, -np.pi / 4, np.pi / 4
    goal = ee_goal((0.0, -0.55, 0.35), x_target=x_init.numpy(), device="cpu")
    goals = {k: torch.stack([v] * 10) for k, v in goal.items()}
    goals["ee_goal"] = goals["ee_goal"] + torch.linspace(0, 0.05, 10)[:, None]
    on = lambda g: {k: v.to(dev) for k, v in g.items()}
    ctrl = MPCController(prob.plant, prob.cost, cfg, MPCConfig(max_iters_per_solve=3))
    run = make_device_mpc_loop(ctrl, sim_rate_hz=200.0, control_period_s=0.02)
    st_cpu = ctrl.init_state(x_init, goal=goal, weights=w, warmup_iters=6)
    st = MPCState(*(a.to(dev) for a in st_cpu))
    x_dev, t_dev = x_init.to(dev), torch.full((), 0.01, device=dev)
    three = {k: v[:3] for k, v in goals.items()}
    step = ctrl.step(st, x_dev, t_dev, on(goal), w)
    loop = run(st, x_dev, 0.0, on(three), w)
    assert loop.host_syncs == 0 and ctrl.host_syncs == 0
    with monkeypatch.context() as m:          # the same bodies run eagerly on the card
        m.setattr(graphs, "replayed", lambda device: False)
        eager_step = ctrl.step(st, x_dev, t_dev, on(goal), w)
        eager_loop = run(st, x_dev, 0.0, on(three), w)
    assert eager_loop.host_syncs > 0
    for a, b in zip(step[0] + step[1], eager_step[0] + eager_step[1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    for a, b in zip(loop[:5] + tuple(loop.state), eager_loop[:5] + tuple(eager_loop.state)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    cpu_step = ctrl.step(st_cpu, x_init, t_dev.cpu(), goal, w)
    assert bool(step[1].accepted) == bool(cpu_step[1].accepted)
    torch.testing.assert_close(step[1].J.cpu(), cpu_step[1].J, rtol=1e-3, atol=0)
    # three closed-loop steps: the plant states the two take their later
    # solves from part by rounding, so J is held on the first step only
    cpu = run(st_cpu, x_init, 0.0, three, w)
    assert torch.equal(loop.accepted.cpu(), cpu.accepted)
    torch.testing.assert_close(loop.ee_err.cpu(), cpu.ee_err, rtol=0, atol=1e-4)
    torch.testing.assert_close(loop.J.cpu()[0], cpu.J[0], rtol=1e-3, atol=0)

    solver = make_ilqr_solver(prob.plant, prob.cost, cfg)
    args, kw = (st.x, st.u, on(goal)), dict(P0=st.P, p0=st.p, d0=st.d)
    solver(*args, **kw)
    run(st, x_dev, t_dev, on(goals), w)        # captures before the checked calls
    goals_dev, goal_dev = on(goals), on(goal)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        solver(*args, **kw)
        ctrl.step(st, x_dev, t_dev, goal_dev, w)
        run(st, x_dev, t_dev, goals_dev, w)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_capture_failure_raises(dev):
    """A body that reads a device value on the host cannot be captured: the
    capture raises with the CUDA error, nothing runs it eagerly."""
    from parallel_ddp_tpu_torch import graphs

    def body(x):
        if bool(x.sum() > 0):          # a host read: illegal under capture
            x.add_(1.0)
        return x

    with pytest.raises(RuntimeError):
        graphs.Captured(body, (torch.ones(3, device=dev),), "host read")


# --- scenario batching: the kernels' scenario axis, the batched solve

def _rollout_batch(rng, B, A, M, nf, dev):
    N = M * nf
    return (_f32(rng, (B, A, N, 14), 0.3, dev), _f32(rng, (B, N, 7), 1.0, dev),
            _f32(rng, (B, N, 7, 14), 0.05, dev), _f32(rng, (B, N, 7), 0.5, dev),
            _f32(rng, (B, N, 14), 0.3, dev),
            torch.pow(0.5, torch.arange(A, dtype=torch.float32, device=dev)))


def _riccati_batch(rng, B, Mb, Nb, dev, n=14, m=7):
    nm = n + m
    C = rng.normal(0, 0.3, (B, Mb, Nb, nm, nm))
    H = torch.as_tensor((np.einsum("...ij,...lj->...il", C, C) + np.eye(nm)).astype(np.float32),
                        device=dev)
    Cp = rng.normal(0, 0.3, (B, Mb, n, n))
    sP = torch.as_tensor((np.einsum("...ij,...lj->...il", Cp, Cp) + np.eye(n)).astype(np.float32),
                         device=dev)
    rho = torch.as_tensor(rng.uniform(0.2, 2.0, B).astype(np.float32), device=dev)
    return (rho, sP, _f32(rng, (B, Mb, n), 0.5, dev), _f32(rng, (B, Mb, Nb, n, nm), 0.3, dev), H,
            _f32(rng, (B, Mb, Nb, nm), 0.5, dev), _f32(rng, (B, Mb, Nb, n), 0.1, dev),
            torch.arange(Mb * Nb, device=dev).reshape(Mb, Nb))


@pytest.mark.parametrize("B", [1, 5, 70])
def test_batched_kernels_match_plain_and_per_scenario_launches(dev, B):
    """The rollout and Riccati kernels with a scenario axis: within the
    plain versions' tolerances of test_rollout_kernel / test_riccati_kernel,
    and each scenario bit for bit its own launch (a scenario's thread blocks
    run the same program whatever B is)."""
    from parallel_ddp_tpu_torch.config import SolverConfig

    rng = np.random.default_rng(B)
    A, M, nf = 16, 4, 16
    fused = cuda_rollout.make_kuka_fused_rollout(1, 0.0, 1, 0.5 / 63, M * nf, M, A)
    args = _rollout_batch(rng, B, A, M, nf, dev)
    before = cuda_rollout.kuka_rollout_cuda.counter.launches
    got = fused(*args)
    assert cuda_rollout.kuka_rollout_cuda.counter.launches == before + 1
    ref = fused(*[a.cpu() for a in args])
    for g, r in zip(got, ref):
        assert g.shape == (B, A, M, nf, g.shape[-1])
        torch.testing.assert_close(g.cpu(), r, rtol=1e-4,
                                   atol=1e-5 * max(float(r.abs().max()), 1.0))
    for b in {0, B // 2, B - 1}:
        for g, r in zip(got, fused(*(a[b] for a in args[:5]), args[5])):
            assert torch.equal(g[b], r)

    Mb, Nb = 4, 16
    cfg = SolverConfig(num_time_steps=Mb * Nb, m_blocks_b=Mb, m_blocks_f=4, num_alpha=A)
    bp = cuda_riccati.make_riccati_block_call(cfg, 14, 7)
    rargs = _riccati_batch(rng, B, Mb, Nb, dev)
    got = bp(*rargs)
    assert got[6].shape == (B, 2) and got[7].shape == (B,) and not bool(got[7].any())
    ref = bp(*[a.cpu() for a in rargs])
    for g, r in zip(got[:7], ref[:7]):
        torch.testing.assert_close(g.cpu(), r, rtol=1e-4,
                                   atol=1e-5 * max(float(r.abs().max()), 1.0))
    for b in {0, B // 2, B - 1}:
        one = bp(rargs[0][b], *(a[b] for a in rargs[1:7]), rargs[7])
        for g, r in zip(got, one):
            assert torch.equal(g[b], r)
    # one indefinite scenario fails alone
    bad = list(rargs)
    bad[4] = rargs[4].clone()
    bad[4][B - 1, ..., 14:, 14:] -= 50.0 * torch.eye(7, device=dev)
    assert bp(*bad)[7].tolist() == [False] * (B - 1) + [True]


def _batch_goals(B, dev):
    from parallel_ddp_tpu_torch.presets import ee_goal, figure8_goal

    goals = [ee_goal(figure8_goal(1.0 + 8.0 * b / B)[0], device=dev) for b in range(B)]
    return {k: torch.stack([g[k] for g in goals]) for k in goals[0]}


def test_batched_solve_graph_matches_single_graphs(dev):
    """A batched cold solve (one graph replay, tol_cost 0.01 so scenarios
    stop at different iterations) against each scenario solved alone
    through the single solver's graph, and a B = 2 batch against the same
    batch on CPU tensors: the same iterations and alphas, J within 1e-3.
    Four iterations: the batch's glue rounds otherwise than a single
    solve's, and at this small size the rounding grows fast (ROADMAP.md,
    known deviations: 0.28 % of J by the 7th iteration of an 8-iteration
    solve on the card, the same alphas)."""
    from parallel_ddp_tpu_torch.parallel.sharding import make_batched_solver
    from parallel_ddp_tpu_torch.solver import make_ilqr_solver

    prob, cfg = _small_problem(4)
    cfg = dataclasses.replace(cfg, tol_cost=0.01)
    B = 6
    goals = _batch_goals(B, dev)
    goals["ee_goal"][-1, :3] = torch.tensor([0.005, 0.0, 1.3195], device=dev)   # near home
    x0, u0 = torch.zeros(B, 16, 14, device=dev), torch.zeros(B, 16, 7, device=dev)
    solve = make_batched_solver(prob.plant, prob.cost, cfg)
    out = solve(x0, u0, goals)
    assert solve.solver.host_syncs == 0 and len(set(out.iters.tolist())) > 1
    single = make_ilqr_solver(prob.plant, prob.cost, cfg)
    for b in range(B):
        one = single(x0[b], u0[b], {k: v[b] for k, v in goals.items()}, initial_rollout=True)
        it = int(one.iters)
        assert int(out.iters[b]) == it
        assert torch.equal(out.alpha_trace[b, :it + 1], one.alpha_trace[:it + 1])
        torch.testing.assert_close(out.J_trace[b, :it + 1], one.J_trace[:it + 1], rtol=1e-3, atol=0)
    cpu = make_batched_solver(prob.plant, prob.cost, cfg)(
        x0[:2].cpu(), u0[:2].cpu(), {k: v[:2].cpu() for k, v in goals.items()})
    for b in range(2):
        _assert_same_decisions(
            type(out)(*(a[b] for a in out)), type(cpu)(*(a[b] for a in cpu)))


@pytest.mark.parametrize("B", [2, 64])
def test_batched_launches_do_not_depend_on_B(dev, B):
    """A batched 3-iteration solve (tol_cost 0) launches the Jacobian and the
    rollout kernel 3 times each and the Riccati kernel 3 times plus retries,
    whatever B is: the kernels take the scenario axis, no Python loop does."""
    from parallel_ddp_tpu_torch.parallel.sharding import make_batched_solver

    prob, cfg = _small_problem(3)
    cfg = dataclasses.replace(cfg, tol_cost=0.0)
    solve = make_batched_solver(prob.plant, prob.cost, cfg)
    x0, u0 = torch.zeros(B, 16, 14, device=dev), torch.zeros(B, 16, 7, device=dev)
    goals = _batch_goals(B, dev)
    solve(x0, u0, goals)                          # the capture
    counters = (cuda_rbd.kuka_jac_qdd_cuda.counter, cuda_rollout.kuka_rollout_cuda.counter,
                cuda_riccati.riccati_cuda.counter)
    for c in counters:
        c.reset()
    out = solve(x0, u0, goals)
    assert out.iters.tolist() == [3] * B
    jac, roll, ric = (c.launches for c in counters)
    assert jac == roll == 3 and ric == 3


def test_weight_change_makes_no_capture_and_no_sync(dev):
    """A new weight value takes effect in the replayed solve with no new
    capture; a value seen before makes no stream sync."""
    from parallel_ddp_tpu_torch.config import CostWeights
    from parallel_ddp_tpu_torch.presets import ee_goal
    from parallel_ddp_tpu_torch.solver import make_ilqr_solver

    prob, cfg = _small_problem(3)
    solver = make_ilqr_solver(prob.plant, prob.cost, cfg)
    x0, u0 = torch.zeros(16, 14, device=dev), torch.zeros(16, 7, device=dev)
    goal = ee_goal((0.3, -0.3, 0.9), device=dev)
    first = solver(x0, u0, goal, initial_rollout=True)
    w2 = CostWeights(q_ee1=0.3, r_ee=2e-4)
    second = solver(x0, u0, goal, w2, initial_rollout=True)
    assert len(solver.graphs) == 1 and not torch.equal(first.J_trace, second.J_trace)
    cpu = make_ilqr_solver(prob.plant, prob.cost, cfg)(
        x0.cpu(), u0.cpu(), {k: v.cpu() for k, v in goal.items()}, w2, initial_rollout=True)
    _assert_same_decisions(second, cpu)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        solver(x0, u0, goal, w2, initial_rollout=True)
        solver(x0, u0, goal, initial_rollout=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_ee_velocity_cost_is_captured(dev):
    """The EE-velocity cost (nested torch.func.jacfwd under vmap in its
    Hessian) in a replayed solve at the WAFR size: the same body run
    eagerly on the card (rtol 1e-5), and the CPU's decisions with J within
    1e-3.  (At N = 16 the card's and the CPU's J part by rounding within 4
    iterations, 0.37 %, with the same alphas: ROADMAP.md, known
    deviations.)"""
    from parallel_ddp_tpu_torch.config import CostWeights
    from parallel_ddp_tpu_torch.presets import ee_goal, kuka_ee
    from parallel_ddp_tpu_torch.solver import make_ilqr_solver

    prob = kuka_ee(use_ee_vel=True)
    cfg = dataclasses.replace(prob.cfg, max_iter=3, pallas_riccati=True)
    w = CostWeights(q_eev1=0.05, qf_eev1=5.0)
    goal = ee_goal((0.3, -0.3, 0.9), device="cpu")
    goal["ee_vel_goal"] = torch.zeros(6)
    goal_dev = {k: v.to(dev) for k, v in goal.items()}
    x0, u0 = torch.zeros(64, 14), torch.zeros(64, 7)
    gpu = make_ilqr_solver(prob.plant, prob.cost, cfg)
    out = gpu(x0.to(dev), u0.to(dev), goal_dev, w, initial_rollout=True)
    assert gpu.host_syncs == 0 and len(gpu.graphs) == 1
    eager, reads = gpu.run(x0.to(dev), u0.to(dev), goal_dev, None, None, None, cfg.max_iter, w,
                           True, False)
    assert reads > 0
    _assert_same_run(out, eager)
    cpu = make_ilqr_solver(prob.plant, prob.cost, cfg)(x0, u0, goal, w, initial_rollout=True)
    assert (cpu.alpha_trace[1:] >= 0).any()
    _assert_same_decisions(out, cpu)


# --- the WAFR example's other four problems (presets without kernel hooks,
# and the Kuka with gravity on and finite differences)

PRESET_CASES = {
    "pendulum": ("pendulum_swingup", dict(total_time=1.0), [np.pi, 0.0], 0.0),
    "cartpole": ("cartpole_swingup", dict(total_time=1.0), [0.0, np.pi, 0.0, 0.0], 0.0),
    "quadrotor": ("quadrotor_task", dict(total_time=1.0), [1.0, 1.0, 0.5] + [0.0] * 9,
                  9.81 * 0.5 / 4.0),
    "kuka_joint": ("kuka_joint", {}, [-0.5, 1.0, -0.3, 0.5, 0.7, 0.7, 0.0] + [0.0] * 7, 0.0),
    "kuka_joint_fd": ("kuka_joint", {}, [-0.5, 1.0, -0.3, 0.5, 0.7, 0.7, 0.0] + [0.0] * 7, 0.0),
}


@pytest.mark.parametrize("name", list(PRESET_CASES))
def test_preset_graphed_solve_matches_eager(dev, name):
    """Each preset (N = 16, 2 blocks, 4 alphas, the fused Riccati sweep) as
    one graph replay against the same body run eagerly on the card, with 0
    host reads; the plants without kernel hooks capture their step and their
    vmapped jacfwd node by node; kuka_joint_fd's derivative stage is the FD
    AB through the forward-dynamics kernel."""
    from parallel_ddp_tpu_torch import presets
    from parallel_ddp_tpu_torch.config import CostWeights
    from parallel_ddp_tpu_torch.solver import make_ilqr_solver

    preset, kw, goal, u_start = PRESET_CASES[name]
    prob = getattr(presets, preset)(num_time_steps=16, m_blocks=2, num_alpha=4, **kw)
    cfg = dataclasses.replace(prob.cfg, max_iter=6, pallas_riccati=True,
                              use_finite_diff=name.endswith("_fd"))
    solver = make_ilqr_solver(prob.plant, prob.cost, cfg)
    n, m = prob.plant.n_state, prob.plant.n_ctrl
    x0 = torch.zeros(16, n, device=dev)
    if n == 14:
        x0 += torch.as_tensor(np.random.default_rng(0).normal(0, 0.5, 14).astype(np.float32),
                              device=dev)
    u0 = torch.full((16, m), u_start, device=dev)
    g = torch.tensor(goal, dtype=torch.float32, device=dev)
    counters = (cuda_riccati.riccati_cuda.counter, cuda_rbd.kuka_qdd_cuda.counter)
    for c in counters:
        c.reset()
    graphed = solver(x0, u0, g, initial_rollout=True)
    assert solver.host_syncs == 0 and len(solver.graphs) == 1
    eager, reads = solver.run(x0, u0, g, None, None, None, cfg.max_iter, CostWeights(), True,
                              False)
    assert reads > 0
    _assert_same_run(graphed, eager)
    assert cuda_riccati.riccati_cuda.counter.launches > 0
    if name.endswith("_fd"):
        assert cuda_rbd.kuka_qdd_cuda.counter.launches > 0


def test_urdf_graphed_solve_matches_eager(dev):
    """The packaged iiwa-14 URDF (urdf_problem's EE cost on the spatial-
    algebra core) at N = 16, 2 blocks, 4 alphas, Euler, with the fused
    Riccati sweep: one graph replay against the same body run eagerly on the
    card, with 0 host reads; the core's dynamics, its vmapped jacfwd AB and
    the cost are captured op by op (the Cholesky solve by cuBLAS triangular
    solves: MAGMA's batched one cannot be captured)."""
    from parallel_ddp_tpu_torch import presets
    from parallel_ddp_tpu_torch.config import CostWeights
    from parallel_ddp_tpu_torch.models.urdf import IIWA14_URDF
    from parallel_ddp_tpu_torch.solver import make_ilqr_solver

    prob = presets.urdf_problem(IIWA14_URDF, ee=True, gravity=0.0, num_time_steps=16,
                                total_time=0.5, m_blocks=2, num_alpha=4, integrator=1)
    cfg = dataclasses.replace(prob.cfg, max_iter=6, pallas_riccati=True)
    solver = make_ilqr_solver(prob.plant, prob.cost, cfg)
    x_start = (np.random.default_rng(0).standard_normal(14) * 0.3).astype(np.float32)
    x0 = torch.as_tensor(np.broadcast_to(x_start, (16, 14)).copy(), device=dev)
    u0 = torch.zeros(16, 7, device=dev)
    g = presets.ee_goal([0.3, -0.5, 0.4], device=dev)
    cuda_riccati.riccati_cuda.counter.reset()
    graphed = solver(x0, u0, g, initial_rollout=True)
    assert solver.host_syncs == 0 and len(solver.graphs) == 1
    eager, reads = solver.run(x0, u0, g, None, None, None, cfg.max_iter, CostWeights(), True,
                              False)
    assert reads > 0
    _assert_same_run(graphed, eager)
    assert cuda_riccati.riccati_cuda.counter.launches > 0


# --- box constraints: the AL cost and the constrained MPC period

@pytest.mark.parametrize("kind", ["pendulum", "kuka_ee"])
def test_al_cost_on_the_card_matches_cpu(dev, kind):
    """The AL cost's stage, gradient and Hessian on the card against the same
    call on CPU tensors (lam mixing active and inactive rows): rtol 1e-5 of
    each quantity's scale, the CPU tests' bound against the JAX package."""
    from parallel_ddp_tpu_torch import presets
    from parallel_ddp_tpu_torch.constraints import BoxConstraints, al_cost

    rng = np.random.default_rng(4)
    N = 16
    if kind == "pendulum":
        prob = presets.pendulum_swingup(num_time_steps=N, m_blocks=2, num_alpha=4)
        con = BoxConstraints(n_state=2, n_ctrl=1, u_min=[-1.0], u_max=[1.0],
                             x_min=[-0.5, -1.0], x_max=[0.5, 1.0])
        base_goal = torch.tensor([np.pi, 0.0])
        x, u = rng.normal(0, 1.0, (N, 2)), rng.normal(0, 2.0, (N, 1))
    else:
        prob = presets.kuka_ee(num_time_steps=N, m_blocks=2, num_alpha=4)
        con = BoxConstraints(n_state=14, n_ctrl=7, u_min=[-40.0] * 7, u_max=[40.0] * 7)
        base_goal = presets.ee_goal([0.3, -0.3, 0.9], device="cpu")
        x, u = rng.normal(0, 1.0, (N, 14)), rng.normal(0, 40.0, (N, 7))
    cost = al_cost(prob.cost, con, N - 1)
    lam = np.abs(rng.normal(0, 5.0, (N, con.n_c))) * (rng.random((N, con.n_c)) < 0.5)
    goal = {"base": base_goal, "lam": torch.as_tensor(lam, dtype=torch.float32),
            "mu": torch.tensor(50.0)}
    to = lambda g: {k: to(v) for k, v in g.items()} if isinstance(g, dict) else g.to(dev)
    args = [torch.as_tensor(a, dtype=torch.float32) for a in (x, u)] + [torch.arange(N)]
    cpu = (cost.stage(*args, goal, None),) + cost.quad(*args, goal, None)
    gpu = (cost.stage(*[a.to(dev) for a in args], to(goal), None),) + cost.quad(
        *[a.to(dev) for a in args], to(goal), None)
    for g, c in zip(gpu, cpu):
        torch.testing.assert_close(g.cpu(), c, rtol=1e-5, atol=1e-5 * float(c.abs().max()))


def test_al_mpc_period_is_one_replay_with_no_host_read(dev):
    """A constrained MPC period (tests/test_constraints.py's pendulum
    controller, N = 48) replayed on the card: 0 host reads by the
    controller's count and under torch's sync debug mode "error"; the same
    body run eagerly on the card gives the same numbers; new lam and mu are
    no new capture; the CPU takes the same accept decision, J within 1e-3."""
    from parallel_ddp_tpu_torch import graphs, presets
    from parallel_ddp_tpu_torch.constraints import ALMPCController, BoxConstraints
    from parallel_ddp_tpu_torch.mpc.driver import MPCConfig, MPCState

    prob = presets.pendulum_swingup(num_time_steps=48, total_time=2.0, m_blocks=2, num_alpha=8)
    cfg = dataclasses.replace(prob.cfg, pallas_riccati=True)
    con = BoxConstraints(n_state=2, n_ctrl=1, u_min=[-6.0], u_max=[6.0])
    ctrl = ALMPCController(prob.plant, prob.cost, cfg, MPCConfig(max_iters_per_solve=6), con,
                           mu=50.0)
    goal_cpu = torch.tensor([np.pi, 0.0])
    st_cpu, lam_cpu = ctrl.init_state(torch.zeros(2), goal=goal_cpu)
    st, lam = MPCState(*(a.to(dev) for a in st_cpu)), lam_cpu.to(dev)
    goal, x = goal_cpu.to(dev), torch.zeros(2, device=dev)
    t = torch.full((), 0.02, device=dev)
    st1, lam1, info = ctrl.step(st, lam, x, t, goal)             # the capture
    assert ctrl.host_syncs == 0 and len(ctrl.graphs) == 1
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = ctrl.step(st, lam, x, t, goal)
        other = ctrl.step(st1, lam1 + 0.5, x, t + 0.02, goal)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ctrl.host_syncs == 0 and len(ctrl.graphs) == 1
    assert not torch.equal(other[2].J, again[2].J)
    with pytest.MonkeyPatch.context() as m:                      # the body, eagerly
        m.setattr(graphs, "replayed", lambda device: False)
        eager = ctrl.step(st, lam, x, t, goal)
    for a, b in zip(tuple(again[0]) + (again[1],) + tuple(again[2]),
                    tuple(eager[0]) + (eager[1],) + tuple(eager[2])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    cpu = ctrl.step(st_cpu, lam_cpu, torch.zeros(2), 0.02, goal_cpu)
    assert bool(info.accepted) == bool(cpu[2].accepted)
    torch.testing.assert_close(info.J.cpu(), cpu[2].J, rtol=1e-3, atol=0)


def test_pick_place_loop_replayed_matches_eager(dev):
    """Five control steps of the pick-and-place device loop replayed on the
    card (one graph a step, the waypoint index on the device, no host read)
    against the same body run eagerly on the card: the same waypoint
    indices, accepts and ok flags, and the same states but for cuBLAS
    choosing another algorithm under capture (rtol 1e-5)."""
    from parallel_ddp_tpu_torch.mpc.driver import MPCConfig, MPCController, MPCState
    from parallel_ddp_tpu_torch.tasks.pick_and_place import (PickAndPlaceConfig,
                                                             make_pick_place_device_loop)

    prob, cfg = _small_problem()
    ctrl = MPCController(prob.plant, prob.cost, cfg, MPCConfig(max_iters_per_solve=2))
    wps = np.asarray([[0.1, 0.1, 1.2], [0.1, -0.1, 1.2]], np.float32)
    run = make_pick_place_device_loop(ctrl, wps, PickAndPlaceConfig(e_norm_lim=0.35,
                                                                    v_norm_lim=2.0),
                                      sim_rate_hz=200.0, control_period_s=0.05)
    z = lambda *shape: torch.zeros(shape, device=dev)
    st = MPCState(z(16, 14), z(16, 7), z(16, 7, 14), z(16, 14, 14), z(16, 14), z(16, 14),
                  z(), torch.zeros((), dtype=torch.int32, device=dev))
    x0 = z(14)
    graphed = run(st, x0, 0.0, 5)
    eager = run(st, x0, 0.0, 5, replay=False)
    assert graphed.host_syncs == 0 and eager.host_syncs > 0 and len(run.graphs) == 1
    assert int(graphed.waypoints_done) == int(eager.waypoints_done) == 2
    for name in ("wp_idx", "accepted", "ok"):
        assert torch.equal(getattr(graphed, name), getattr(eager, name)), name
    for name in ("x", "e_norm", "v_norm", "J"):
        torch.testing.assert_close(getattr(graphed, name), getattr(eager, name), rtol=1e-5,
                                   atol=1e-6, msg=name)


def test_mpc_loop_node_one_read_and_no_capture_after_warmup(dev):
    """The solver node on the card: `warmup` captures the cold start's solve
    and the MPC step; solves after a new goal, a new cost set, a shift
    toggle and a new iteration limit replay them (no new capture), each
    with one read to the host."""
    from parallel_ddp_tpu_torch.config import CostWeights
    from parallel_ddp_tpu_torch.mpc.driver import MPCConfig, MPCController
    from parallel_ddp_tpu_torch.runtime import messages as msg
    from parallel_ddp_tpu_torch.runtime import nodes

    class Bus:
        def subscribe(self, channel):
            pass

    prob, cfg = _small_problem()
    ctrl = MPCController(prob.plant, prob.cost, cfg, MPCConfig(max_iters_per_solve=3))
    goal = msg.Goal(2, np.asarray([0.5, 0.5, 0.1, 0, 0, 0], np.float32))
    node = nodes.MPCLoopNode(ctrl, Bus(), nodes.ee_goal_to_pytree, goal, device=dev)
    x0 = np.zeros(14, np.float32)
    node.state = node.warmup(x0)
    captured = node.captures()
    assert captured == 2
    changes = [
        lambda: setattr(node, "goal", msg.Goal(2, np.asarray([0.4, -0.5, 0.1, 0, 0, 0],
                                                              np.float32))),
        lambda: setattr(node, "weights", CostWeights(q_ee1=75.0, qf_ee1=500.0)),
        lambda: setattr(node, "solver_params", msg.SolverParams(1, 10.0, False, 1)),
        lambda: setattr(node, "solver_params", msg.SolverParams(3, 50.0, False, 0)),
    ]
    for k, change in enumerate(changes):
        change()
        traj = node.solve(msg.Status(0.01 * (k + 1), x0[:7], x0[7:]))
        assert traj.x.shape == (16, 14) and np.isfinite(traj.x).all()
    assert node.captures() == captured
    assert node.host_reads == node.solve_count == len(changes)
    assert node.solve_trace[2][2] == 1


# --- the exact log-depth backward pass (bp_assoc_scan)

def _assoc_lqr_inputs(N, seed=0):
    """Random LQR data at the Kuka's (14, 7): AB ~ N(0, 0.2) (a stable A),
    symmetric H = C C' + 0.5 I, defects on the 16-knot shooting boundaries;
    numpy, for both devices."""
    rng = np.random.default_rng(seed)
    n, m = 14, 7
    AB = rng.normal(0, 0.2, (N - 1, n, n + m)).astype(np.float32)
    C = rng.normal(0, 0.3, (N, n + m, n + m))
    H = (np.einsum("kij,klj->kil", C, C) + 0.5 * np.eye(n + m)).astype(np.float32)
    g = rng.normal(0, 1.0, (N, n + m)).astype(np.float32)
    d = np.zeros((N, n), np.float32)
    d[15:N - 1:16] = rng.normal(0, 0.1, d[15:N - 1:16].shape)
    zeros = lambda *s: np.zeros(s, np.float32)
    return [AB, H, g, zeros(N, n, n), zeros(N, n), d, zeros(N, n), zeros(N, n)]


@pytest.mark.parametrize("N", [64, 256])
def test_assoc_backward_on_the_card_matches_cpu(dev, N):
    """The exact pass on CUDA tensors against the same pass on CPU tensors:
    cuBLAS / cuSOLVER and the CPU's BLAS / LAPACK round in another order
    (|card - cpu| <= 1e-3 |cpu| + 1e-4 max|cpu|, as
    tests/test_torch_assoc_bp.py holds the port to the reference)."""
    from parallel_ddp_tpu_torch.config import SolverConfig
    from parallel_ddp_tpu_torch.parallel.backward import backward_pass

    cfg = SolverConfig(num_time_steps=N, total_time=1.0, m_blocks_b=1, m_blocks_f=N // 16,
                       num_alpha=4, state_reg=False, bp_assoc_scan=True)
    args = _assoc_lqr_inputs(N)
    rho, drho = torch.tensor(1.0), torch.tensor(1.0)
    cpu = backward_pass(cfg, *(torch.as_tensor(a) for a in args), rho, drho)
    gpu = backward_pass(cfg, *(torch.as_tensor(a, device=dev) for a in args), rho.to(dev),
                        drho.to(dev))
    assert not bool(cpu.fail) and not bool(gpu.fail)
    assert float(gpu.rho) == float(cpu.rho)
    for name in ("P", "p", "K", "du", "ApBK", "Bdu", "dJexp"):
        want = getattr(cpu, name)
        torch.testing.assert_close(getattr(gpu, name).cpu(), want, rtol=1e-3,
                                   atol=1e-4 * float(want.abs().max()), msg=name)


def test_assoc_solve_replayed_matches_eager_with_no_sync(dev):
    """The bp_assoc_scan solve as one replay: the same body run eagerly on
    the card, the CPU's decisions, no Riccati launch; new goals and weights
    make no new capture and no stream sync."""
    from parallel_ddp_tpu_torch.config import CostWeights
    from parallel_ddp_tpu_torch.presets import ee_goal
    from parallel_ddp_tpu_torch.solver import make_ilqr_solver

    prob, cfg = _small_problem()
    cfg = dataclasses.replace(cfg, pallas_riccati=False, state_reg=False, bp_assoc_scan=True)
    solver = make_ilqr_solver(prob.plant, prob.cost, cfg)
    x0, u0 = torch.zeros(16, 14, device=dev), torch.zeros(16, 7, device=dev)
    goals = [ee_goal(g, device=dev) for g in ((0.3, -0.3, 0.9), (0.35, -0.25, 0.85))]
    cuda_riccati.riccati_cuda.counter.reset()
    cuda_rbd.kuka_jac_qdd_cuda.counter.reset()
    cold = solver(x0, u0, goals[0], initial_rollout=True)
    torch.cuda.synchronize()
    assert cuda_riccati.riccati_cuda.counter.launches == 0
    assert cuda_rbd.kuka_jac_qdd_cuda.counter.launches > 0
    eager, reads = solver.run(x0, u0, goals[0], None, None, None, cfg.max_iter, CostWeights(),
                              True, False)
    assert reads > 0
    _assert_same_run(cold, eager)
    cpu = make_ilqr_solver(prob.plant, prob.cost, cfg)(
        x0.cpu(), u0.cpu(), {k: v.cpu() for k, v in goals[0].items()}, initial_rollout=True)
    _assert_same_decisions(cold, cpu)
    w2 = CostWeights(q_ee1=0.3, r_ee=2e-4)
    second = solver(x0, u0, goals[1], w2, initial_rollout=True)
    assert len(solver.graphs) == 1 and solver.host_syncs == 0
    assert not torch.equal(second.J_trace, cold.J_trace)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        solver(x0, u0, goals[0], w2, initial_rollout=True)
        solver(x0, u0, goals[1], initial_rollout=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert len(solver.graphs) == 1
