"""Horizon ('sp') sharding in the port (parallel_ddp_tpu_torch/parallel/sp.py)
and the shard mesh (parallel/sharding.py `Mesh`, `Collectives`), on the CPU.

The reference's tests/test_sp.py holds its sp solve to its single-device
solve on an 8-device CPU mesh; here every shard of a mesh lives in this
process (the chunk axis a dim of the tensors) unless a process group says
otherwise:
  * the pendulum (N = 64, 8 blocks, 8 alphas, 12 iterations) at S = 4
    against the JAX package's `make_sp_solver` at sp = 4, and at S = 2 / 4 / 8
    against the port's own single solve, with tests/test_sp.py:41-51's
    bands (the same iterations and alphas, J rtol 1e-5, J_trace rtol 1e-4,
    x 1e-4, u rtol 1e-4 / atol 1e-3);
  * the Kuka EE solve (N = 16, 2 blocks, 4 alphas, 6 iterations; the JAX
    package on its CPU `rbd` core) at S = 2 against the JAX sp solve and
    against the port's single solve; with `pallas_riccati` (the Riccati
    op's plain version at the chunk's lanes and global step indices)
    against the same sp solve without it;
  * the cart-pole at S = 4 and a 2 x 2 (dp, sp) mesh against single solves;
  * the errors, the options the sp path does not read, the graph route
    under `graphs.emulate()`, and a 2-rank `gloo` run (tests/torch_sp_ranks.py)
    bit for bit against the in-process one.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from parallel_ddp_tpu.parallel.sharding import make_mesh as ref_make_mesh
from parallel_ddp_tpu.parallel.sp import make_sp_solver as ref_make_sp_solver
from parallel_ddp_tpu.presets import ee_goal as ref_ee_goal
from parallel_ddp_tpu.presets import kuka_ee as ref_kuka_ee
from parallel_ddp_tpu.presets import pendulum_swingup as ref_pendulum_swingup
from parallel_ddp_tpu_torch import graphs, interop
from parallel_ddp_tpu_torch.parallel.sharding import Collectives, Mesh, make_mesh
from parallel_ddp_tpu_torch.parallel.sp import make_batched_sp_solver, make_sp_solver
from parallel_ddp_tpu_torch.presets import cartpole_swingup, ee_goal, kuka_ee, pendulum_swingup
from parallel_ddp_tpu_torch.solver import make_ilqr_solver

import torch_sp_ranks

# tests/test_sp.py:41-51: an sp solve against the single-device solve
BANDS = dict(J=1e-5, J_trace=1e-4, x=1e-4, u_rtol=1e-4, u_atol=1e-3)
# tests/test_sp.py:102,106: the Kuka EE solve's
KUKA_J_RTOL, KUKA_X = 1e-4, 1e-3
# the port's Kuka (scalar-channel core) against the JAX package's (its CPU
# `rbd` core): float32 rounding of two dynamics cores (tests/test_torch_solver.py)
CORES_J_RTOL = 2e-3
GOAL = (0.3, -0.3, 0.9)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(got, want):
    for name, a, b in zip(got._fields, got, want):
        assert torch.equal(_bits(a), _bits(b)), name


def _hold(out, ref, J=BANDS["J"], J_trace=BANDS["J_trace"], x=BANDS["x"], u=True):
    """tests/test_sp.py's check of an sp solve against a reference solve."""
    assert int(out.iters) == int(ref.iters)
    np.testing.assert_array_equal(out.alpha_trace.numpy(), ref.alpha_trace.numpy())
    np.testing.assert_allclose(float(out.J), float(ref.J), rtol=J)
    np.testing.assert_allclose(out.J_trace.numpy(), ref.J_trace.numpy(), rtol=J_trace)
    np.testing.assert_allclose(out.x.numpy(), ref.x.numpy(), rtol=x, atol=x)
    if u:
        np.testing.assert_allclose(out.u.numpy(), ref.u.numpy(), rtol=BANDS["u_rtol"],
                                   atol=BANDS["u_atol"])


def _pendulum(max_bp_retries=None):
    prob = pendulum_swingup(num_time_steps=64, m_blocks=8, num_alpha=8)
    cfg = dataclasses.replace(prob.cfg, max_iter=12)
    if max_bp_retries is not None:
        cfg = dataclasses.replace(cfg, max_bp_retries=max_bp_retries)
    return prob, cfg


PEND_ARGS = (torch.zeros(64, 2), torch.zeros(64, 1), torch.tensor([np.pi, 0.0]))


@functools.lru_cache(maxsize=None)
def _pendulum_single():
    prob, cfg = _pendulum()
    return make_ilqr_solver(prob.plant, prob.cost, cfg)(*PEND_ARGS, initial_rollout=True)


@functools.lru_cache(maxsize=None)
def _pendulum_sp(S):
    prob, cfg = _pendulum()
    return make_sp_solver(prob.plant, prob.cost, cfg, make_mesh(S, ("sp",)))(*PEND_ARGS)


def _kuka(pallas_riccati):
    prob = kuka_ee(num_time_steps=16, m_blocks=2, num_alpha=4)
    return prob, dataclasses.replace(prob.cfg, max_iter=6, pallas_riccati=pallas_riccati)


KUKA_ARGS = (torch.zeros(16, 14), torch.zeros(16, 7))


@functools.lru_cache(maxsize=None)
def _kuka_sp(pallas_riccati):
    prob, cfg = _kuka(pallas_riccati)
    return make_sp_solver(prob.plant, prob.cost, cfg, make_mesh(2, ("sp",)))(
        *KUKA_ARGS, ee_goal(list(GOAL), device="cpu"))


def test_mesh_shape_and_collectives():
    """make_mesh / Mesh as jax.sharding.Mesh's shape, and the in-process
    collectives along a dim: the neighbour shift, sums in shard order."""
    mesh = make_mesh(4, ("sp", "dp"))
    assert mesh.shape == {"sp": 4, "dp": 1} and mesh.size == 4 and mesh.ranks == 1
    assert make_mesh().shape == {"dp": 1}
    comm = Collectives(Mesh((2, 3), ("dp", "sp")), "sp")
    assert (comm.size, comm.first, comm.count, comm.group) == (3, 0, 3, None)
    t = torch.arange(12.0).reshape(2, 3, 2)
    torch.testing.assert_close(comm.from_right(t, 1), torch.cat([t[:, 1:], t[:, :1] * 0], 1))
    torch.testing.assert_close(comm.psum(t, 1), (t[:, 0] + t[:, 1]) + t[:, 2], rtol=0, atol=0)
    torch.testing.assert_close(comm.pmax(-t, 1), -t[:, 0])
    assert comm.all_gather(t, 1) is t and comm.scatter(t, 1) is t
    with pytest.raises(ValueError):
        Mesh((2,), ("sp", "dp"))


def test_pendulum_matches_jax_sp():
    """The port at S = 4 against the JAX package's sp solve at sp = 4."""
    ref = ref_pendulum_swingup(num_time_steps=64, m_blocks=8, num_alpha=8)
    cfg = dataclasses.replace(ref.cfg, max_iter=12)
    assert interop.solver_config(cfg) == _pendulum()[1]
    want = ref_make_sp_solver(ref.plant, ref.cost, cfg, ref_make_mesh(4, axis_names=("sp",)))(
        jnp.zeros((64, 2), jnp.float32), jnp.zeros((64, 1), jnp.float32),
        jnp.asarray([np.pi, 0.0], jnp.float32), initial_rollout=True)
    _hold(_pendulum_sp(4), interop.solve_output(want))


@pytest.mark.parametrize("S", [2, 4, 8])
def test_pendulum_matches_single_solve(S):
    out = _pendulum_sp(S)
    assert out.x.shape == (64, 2) and out.P.shape == (64, 2, 2)
    _hold(out, _pendulum_single())


def test_kuka_matches_jax_sp():
    """The Kuka EE solve at S = 2 against the JAX sp solve at sp = 2 (the
    same iterations and alphas; J within the two dynamics cores' band, as
    the port's single solve is held to the JAX one) and against the port's
    single solve within tests/test_sp.py's Kuka bands."""
    ref = ref_kuka_ee(num_time_steps=16, m_blocks=2, num_alpha=4)
    assert "rbd" in ref.plant.name
    cfg = dataclasses.replace(ref.cfg, max_iter=6)
    assert interop.solver_config(cfg) == _kuka(False)[1]
    want = interop.solve_output(ref_make_sp_solver(
        ref.plant, ref.cost, cfg, ref_make_mesh(2, axis_names=("sp",)))(
            jnp.zeros((16, 14), jnp.float32), jnp.zeros((16, 7), jnp.float32),
            ref_ee_goal(list(GOAL)), initial_rollout=True))
    out = _kuka_sp(False)
    assert int(out.iters) == int(want.iters)
    np.testing.assert_array_equal(out.alpha_trace.numpy(), want.alpha_trace.numpy())
    np.testing.assert_allclose(out.J_trace.numpy(), want.J_trace.numpy(), rtol=CORES_J_RTOL)
    prob, cfg = _kuka(False)
    single = make_ilqr_solver(prob.plant, prob.cost, cfg)(
        *KUKA_ARGS, ee_goal(list(GOAL), device="cpu"), initial_rollout=True)
    _hold(out, single, J=KUKA_J_RTOL, J_trace=KUKA_J_RTOL, x=KUKA_X, u=False)
    assert float(out.J) < float(out.J_trace[0])


def test_pallas_riccati_in_the_chunks():
    """The fused Riccati op (its plain version here) at the chunk's Mb / S
    lanes and global step indices: the sp solve without it, bit for bit."""
    _same(_kuka_sp(True), _kuka_sp(False))


def test_cartpole_matches_single_solve():
    prob = cartpole_swingup(num_time_steps=32, m_blocks=4, num_alpha=8)
    cfg = dataclasses.replace(prob.cfg, max_iter=8)
    args = (torch.zeros(32, 4), torch.zeros(32, 1), torch.tensor([0.0, np.pi, 0.0, 0.0]))
    ref = make_ilqr_solver(prob.plant, prob.cost, cfg)(*args, initial_rollout=True)
    out = make_sp_solver(prob.plant, prob.cost, cfg, make_mesh(4, ("sp",)))(*args)
    np.testing.assert_allclose(float(out.J), float(ref.J), rtol=BANDS["J"])
    np.testing.assert_allclose(out.x.numpy(), ref.x.numpy(), rtol=BANDS["x"], atol=BANDS["x"])


def test_dp_sp_mesh_matches_single_solves():
    """tests/test_sp.py:109-143: a 2 x 2 (dp, sp) mesh, B = 4; every
    scenario against its single solve."""
    prob = pendulum_swingup(num_time_steps=32, m_blocks=4, num_alpha=4)
    cfg = dataclasses.replace(prob.cfg, max_iter=8)
    x0s, u0s, goals = torch_sp_ranks.batch_inputs()
    out = make_batched_sp_solver(prob.plant, prob.cost, cfg, Mesh((2, 2), ("dp", "sp")))(
        x0s, u0s, goals)
    assert out.x.shape == (4, 32, 2) and out.J.shape == (4,)
    single = make_ilqr_solver(prob.plant, prob.cost, cfg)
    for b in range(4):
        ref = single(x0s[b], u0s[b], goals[b], initial_rollout=True)
        np.testing.assert_allclose(float(out.J[b]), float(ref.J), rtol=1e-4)
        np.testing.assert_array_equal(out.alpha_trace[b].numpy(), ref.alpha_trace.numpy())
        np.testing.assert_allclose(out.x[b].numpy(), ref.x.numpy(), rtol=1e-3, atol=1e-3)
    with pytest.raises(ValueError):
        make_batched_sp_solver(prob.plant, prob.cost, cfg, Mesh((3, 2), ("dp", "sp")))(
            x0s, u0s, goals)


@pytest.mark.parametrize("case", ["indivisible_blocks", "slq"])
def test_errors(case):
    """tests/test_sp.py:72-76's divisibility check; SLQ is refused."""
    prob = pendulum_swingup(num_time_steps=64, m_blocks=4, num_alpha=4)
    if case == "indivisible_blocks":
        with pytest.raises(ValueError):
            make_sp_solver(prob.plant, prob.cost, prob.cfg, make_mesh(8, ("sp",)))
    else:
        with pytest.raises(NotImplementedError):
            make_sp_solver(prob.plant, prob.cost, dataclasses.replace(prob.cfg, slq=True),
                           make_mesh(2, ("sp",)))


def test_options_the_sp_path_does_not_read():
    """bf16_rollout, bf16_cost and bp_assoc_scan are never read on the sp
    path (the reference's sp.py:95-117, 174-263): the solve with them set
    equals the solve without them bit for bit."""
    prob, cfg = _pendulum()
    cfg = dataclasses.replace(cfg, state_reg=False)
    mesh = make_mesh(4, ("sp",))
    plain = make_sp_solver(prob.plant, prob.cost, cfg, mesh)(*PEND_ARGS)
    flags = dataclasses.replace(cfg, bf16_rollout=True, bf16_cost=True, bp_assoc_scan=True)
    _same(make_sp_solver(prob.plant, prob.cost, flags, mesh)(*PEND_ARGS), plain)


def test_graph_route():
    """One "capture" of the sp solve replayed under `graphs.emulate()`
    (every loop masked over its budget): the host route bit for bit with
    no host reads."""
    prob, cfg = _pendulum(max_bp_retries=2)
    solver = make_sp_solver(prob.plant, prob.cost, cfg, make_mesh(4, ("sp",)))
    want = solver(*PEND_ARGS)
    assert solver.host_syncs > 0
    with graphs.emulate():
        got = solver(*PEND_ARGS)
        assert solver.host_syncs == 0 and len(solver.graphs) == 1
    _same(got, want)


def test_two_ranks_equal_the_in_process_solves(tmp_path):
    """A 2-rank gloo group (spawned processes, CPU) runs the sp solve at
    S = 4 (each rank 2 chunks), a dp-sharded batch and the (dp, sp) batch
    (each rank half the scenarios): every output equals the in-process
    solve's bit for bit, on both ranks."""
    mp.spawn(torch_sp_ranks.worker, args=(2, f"file://{tmp_path}/store", str(tmp_path)),
             nprocs=2, join=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = torch_sp_ranks.solves()
    finally:
        torch.set_num_threads(threads)
    assert want["held"] == ((0, 4), (0, 2))
    for rank in range(2):
        got = torch.load(tmp_path / f"rank{rank}.pt")
        assert got["held"] == ((2 * rank, 2), (rank, 1))
        for name in ("sp4", "dp2", "dp2_sp2"):
            for a, b in zip(got[name], want[name]):
                assert torch.equal(_bits(a), _bits(b)), (rank, name)
