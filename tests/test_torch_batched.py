"""Scenario batching in the port (parallel_ddp_tpu_torch/parallel/sharding.py,
`MPCController.init_state_batch` / `step_batch`), on the CPU at
kuka_ee(num_time_steps=16, m_blocks=2, num_alpha=4).

  * the batched solve against the reference's `make_batched_solver` on a
    one-device mesh (its spatial-algebra `rbd` core, as
    tests/test_torch_solver.py): per scenario the same iterations and alpha
    decisions, J within J_RTOL; one scenario starts near its goal and stops
    on tol_cost before the others;
  * the batched solve against the port's single solve, scenario by
    scenario, and the masked batched body against the host loop's early
    exit, bit for bit;
  * a batched backward pass in which one scenario needs rho retries and the
    other does not, against each scenario's own pass: rho, drho and fail
    exact, every output bit for bit; the batched plain rollout and Riccati
    versions against a loop over the scenarios, bit for bit;
  * the graph route of the batched solve under `graphs.emulate()`: the
    host route bit for bit, no host reads, and a new weight value takes
    effect with no new capture.
The fleet MPC entry points are held against the reference's in
tests/test_torch_batched_mpc.py.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_ddp_tpu.parallel.sharding import make_batched_solver as ref_make_batched_solver
from parallel_ddp_tpu.parallel.sharding import make_mesh
from parallel_ddp_tpu.presets import ee_goal as ref_ee_goal
from parallel_ddp_tpu.presets import kuka_ee as ref_kuka_ee
from parallel_ddp_tpu_torch import graphs, interop
from parallel_ddp_tpu_torch.config import CostWeights
from parallel_ddp_tpu_torch.ops import cuda_riccati, cuda_rollout
from parallel_ddp_tpu_torch.parallel.backward import backward_pass
from parallel_ddp_tpu_torch.parallel.sharding import Mesh, make_batched_solver
from parallel_ddp_tpu_torch.presets import ee_goal, kuka_ee
from parallel_ddp_tpu_torch.solver import _Carry, make_ilqr_solver

N, M, A = 16, 2, 4
MAX_ITER = 6
# a 1 % relative improvement ends a solve: the scenario that starts 7 mm from
# its goal stops after 3 iterations, the two far ones run all 6
TOL_COST = 0.01
GOALS = ((0.3, -0.3, 0.9), (0.35, -0.25, 0.85), (0.005, 0.0, 1.3195))
# spatial-algebra vs scalar-channel float32 dynamics (tests/test_torch_solver.py)
J_RTOL = 2e-3


def _same(a, b, name=""):
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True, msg=name)


def _stack(goals):
    return {k: torch.stack([g[k] for g in goals]) for k in goals[0]}


def _config(max_bp_retries=2):
    """At most 2 rho retries (the solves here need none): a masked run makes
    all of them in every iteration."""
    prob = kuka_ee(num_time_steps=N, m_blocks=M, num_alpha=A)
    cfg = dataclasses.replace(prob.cfg, max_iter=MAX_ITER, tol_cost=TOL_COST,
                              pallas_riccati=True, max_bp_retries=max_bp_retries)
    return prob, cfg


@functools.lru_cache(maxsize=None)
def _port_batch():
    """The port's batched cold solve of the three scenarios (host route)."""
    prob, cfg = _config()
    solve = make_batched_solver(prob.plant, prob.cost, cfg)
    goals = _stack([ee_goal(g, device="cpu") for g in GOALS])
    out = solve(torch.zeros(3, N, 14), torch.zeros(3, N, 7), goals)
    return solve, goals, out


def test_batched_solve_matches_reference():
    ref = ref_kuka_ee(num_time_steps=N, m_blocks=M, num_alpha=A)
    assert "rbd" in ref.plant.name
    prob, cfg = _config()
    ref_cfg = dataclasses.replace(ref.cfg, max_iter=MAX_ITER, tol_cost=TOL_COST,
                                  max_bp_retries=2)
    assert dataclasses.replace(interop.solver_config(ref_cfg), pallas_riccati=True) == cfg
    goals = [ref_ee_goal(list(g)) for g in GOALS]
    ref_goals = {k: jnp.stack([g[k] for g in goals]) for k in goals[0]}
    want = ref_make_batched_solver(ref.plant, ref.cost, ref_cfg, make_mesh(1))(
        jnp.zeros((3, N, 14)), jnp.zeros((3, N, 7)), ref_goals)
    want = interop.solve_output(want)
    solve, _, got = _port_batch()
    assert solve.solver.host_syncs > 0
    iters = got.iters.tolist()
    assert iters == want.iters.tolist() and iters[2] < MAX_ITER == iters[0] == iters[1]
    for b in range(3):
        it = iters[b]
        _same(got.alpha_trace[b, :it + 1], want.alpha_trace[b, :it + 1])
        np.testing.assert_allclose(got.J_trace[b, :it + 1].numpy(),
                                   want.J_trace[b, :it + 1].numpy(), rtol=J_RTOL)
        np.testing.assert_allclose(float(got.J[b]), float(want.J[b]), rtol=J_RTOL)
        assert bool(got.converged[b]) == bool(want.converged[b])


def test_batched_solve_equals_single_solves():
    _, goals, got = _port_batch()
    prob, cfg = _config()
    single = make_ilqr_solver(prob.plant, prob.cost, cfg)
    for b in (0, 2):                    # a scenario that runs the budget, one that stops
        one = single(torch.zeros(N, 14), torch.zeros(N, 7),
                     {k: v[b] for k, v in goals.items()}, initial_rollout=True)
        for name, a in one._asdict().items():
            _same(getattr(got, name)[b], a, f"scenario {b} {name}")


def test_masked_batched_iteration_equals_early_exit():
    """The batched body run for the whole budget, every trip of every
    scenario committed under its own ~done & (it <= cap), against the host
    loop that stops once every scenario is done."""
    prob, cfg = _config()
    solver = make_ilqr_solver(prob.plant, prob.cost, cfg)
    goals = _stack([ee_goal(g, device="cpu") for g in GOALS])
    w = CostWeights()

    def carry():
        return solver._init_carry(torch.zeros(3, N, 14), torch.zeros(3, N, 7), goals, w,
                                  None, None, None, True, False)

    early = carry()
    solver._drive(early, goals, w, MAX_ITER)
    full = carry()
    with graphs.masked():
        for _ in range(MAX_ITER):
            assert solver._iteration(full, goals, w, torch.tensor(MAX_ITER)) == 0
    for name in _Carry.FIELDS:
        _same(getattr(full, name), getattr(early, name), name)
    assert early.done.tolist() == [False, False, True]


def _backward_inputs(indefinite):
    """tests/test_torch_syncless.py's backward-pass case: with `indefinite`
    Huu fails the first Cholesky tests and the pass retries rho."""
    rng = np.random.default_rng(0)
    n, m, nm = 3, 2, 5
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
    return [torch.as_tensor(a) for a in (AB, H, g, Pp, pp, d, x, xp2)]


@pytest.mark.parametrize("pallas", [False, True])
def test_batched_backward_retries_per_scenario(pallas):
    prob, cfg = _config()
    cfg = dataclasses.replace(cfg, m_blocks_b=4, pallas_riccati=pallas)
    scen = [_backward_inputs(True), _backward_inputs(False)]
    rho0, drho0 = torch.tensor([0.1, 0.1]), torch.tensor([1.0, 1.0])
    batched = backward_pass(cfg, *(torch.stack(t) for t in zip(*scen)), rho0, drho0)
    singles = [backward_pass(cfg, *s, rho0[b], drho0[b]) for b, s in enumerate(scen)]
    assert float(singles[0].rho) > 0.1 and torch.equal(singles[1].rho, rho0[1])
    for b, one in enumerate(singles):
        for name, a in one._asdict().items():
            if isinstance(a, torch.Tensor):
                _same(getattr(batched, name)[b], a, f"scenario {b} {name}")
    assert batched.host_syncs == singles[0].host_syncs


def test_batched_plain_kernels_equal_a_loop():
    """The plain rollout and Riccati versions with a scenario axis against
    one call per scenario (what the kernels compute per scenario)."""
    rng = np.random.default_rng(1)
    f = lambda *shape, s=0.3: torch.as_tensor(rng.normal(0, s, shape).astype(np.float32))
    B, dt = 3, 0.5 / 15
    fused = cuda_rollout.make_kuka_fused_rollout(1, 0.0, 1, dt, N, M, A)
    args = (f(B, A, N, 14), f(B, N, 7, s=1.0), f(B, N, 7, 14, s=0.05), f(B, N, 7),
            f(B, N, 14), torch.pow(0.5, torch.arange(A, dtype=torch.float32)))
    got = fused(*args)
    for b in range(B):
        for g, r in zip(got, fused(*(a[b] for a in args[:5]), args[5])):
            _same(g[b], r)
    prob, cfg = _config()
    n, m, Mb, Nb = 14, 7, 2, N // 2
    nm = n + m
    C = rng.normal(0, 0.3, (B, Mb, Nb, nm, nm))
    H = torch.as_tensor((np.einsum("...ij,...lj->...il", C, C) + np.eye(nm)).astype(np.float32))
    Cp = rng.normal(0, 0.3, (B, Mb, n, n))
    sP = torch.as_tensor((np.einsum("...ij,...lj->...il", Cp, Cp) + np.eye(n)).astype(np.float32))
    bp = cuda_riccati.make_riccati_block_call(cfg, n, m)
    rargs = (sP, f(B, Mb, n), f(B, Mb, Nb, n, nm), H, f(B, Mb, Nb, nm), f(B, Mb, Nb, n, s=0.1))
    k_blk = torch.arange(N).reshape(Mb, Nb)
    rho = torch.tensor([0.5, 1.0, 2.0])
    got = bp(rho, *rargs, k_blk)
    assert got[6].shape == (B, 2) and got[7].shape == (B,)
    for b in range(B):
        for g, r in zip(got, bp(rho[b], *(a[b] for a in rargs), k_blk)):
            _same(g[b], r)


def test_graph_route_of_the_batched_solve():
    """One "capture" of the batched solve, replayed: the host route bit for
    bit, no host reads; new goals and a new weight value take effect with
    no new capture."""
    solve, goals, want = _port_batch()
    prob, cfg = _config()
    x0, u0 = torch.zeros(3, N, 14), torch.zeros(3, N, 7)
    w2 = CostWeights(q_ee1=0.2)
    want2 = solve(x0, u0, goals, w2)
    graphed = make_batched_solver(prob.plant, prob.cost, cfg)
    with graphs.emulate():
        got = graphed(x0, u0, goals)
        got2 = graphed(x0, u0, goals, w2)
        assert graphed.solver.host_syncs == 0 and len(graphed.solver.graphs) == 1
    for out, ref in ((got, want), (got2, want2)):
        for name, a in out._asdict().items():
            _same(a, getattr(ref, name), name)
    assert not torch.equal(got2.J, got.J)


@pytest.mark.parametrize("case", ["not_a_mesh", "indivisible_batch"])
def test_mesh_argument(case):
    """`make_batched_solver` takes a port `Mesh`: anything else raises
    TypeError, and a batch that the mesh's 'dp' size does not divide raises
    ValueError (the reference's sharding.py:72-77)."""
    prob, cfg = _config()
    if case == "not_a_mesh":
        with pytest.raises(TypeError):
            make_batched_solver(prob.plant, prob.cost, cfg, mesh=object())
        return
    solve = make_batched_solver(prob.plant, prob.cost, cfg, mesh=Mesh((2,), ("dp",)))
    goals = _stack([ee_goal(g, device="cpu") for g in GOALS])
    with pytest.raises(ValueError):
        solve(torch.zeros(3, N, 14), torch.zeros(3, N, 7), goals)
