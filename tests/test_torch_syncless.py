"""The port's one-program solve on the CPU (parallel_ddp_tpu_torch/graphs.py):
the bodies the card's CUDA graphs hold in WHILE nodes, run eagerly.

  * the iteration body run for its whole budget, every trip committed under
    ~done & (it <= cap) (`graphs.masked`), against the early-exit host loop:
    equal bit for bit (rtol = atol = 0, NaN equal to NaN in the traces), in
    every field of the solver's carry, for a solve that stops on tol_cost,
    one that stops on the budget, one with iter_limit < max_iter and one
    that makes rho retries;
  * the masked rho retry (all max_bp_retries trips) against the reference
    package's `lax.while_loop` retry on the same seeded inputs, with the
    tolerances of tests/test_torch_riccati.py;
  * the graph route of the solver, the MPC step and the closed loop
    (`graphs.emulate`: static buffers, replays, copies out, the loop's
    device step index and its loads of goals) against the host route: equal
    bit for bit, with no host reads.

At N = 16 knots, 2 + 2 blocks, 4 alphas."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_ddp_tpu.config import SolverConfig as RefConfig
from parallel_ddp_tpu.parallel.backward import backward_pass as ref_backward_pass
from parallel_ddp_tpu_torch import graphs, interop
from parallel_ddp_tpu_torch.config import CostWeights
from parallel_ddp_tpu_torch.mpc import device_loop, driver
from parallel_ddp_tpu_torch.parallel.backward import backward_pass
from parallel_ddp_tpu_torch.presets import ee_goal, fig8_weights, kuka_ee
from parallel_ddp_tpu_torch.solver import _Carry, make_ilqr_solver

N, M, A = 16, 2, 4
GOAL = (0.3, -0.3, 0.9)
# (max_iter, tol_cost, iter_limit, cost weights): the cold solve's first step
# improves J by ~30 %, so tol_cost 0.5 ends it there; a negative control
# weight makes Huu indefinite, so the backward pass raises rho
CASES = {
    "stops_on_tol_cost": (3, 0.5, None, None),
    "stops_on_budget": (3, 0.0, None, None),
    "iter_limit_below_max_iter": (3, 0.0, 2, None),
    "rho_retries": (2, 0.0, None, CostWeights(r_ee=-0.3)),
}


def _same(a, b, name=""):
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True, msg=name)


def _solver(max_iter, tol_cost):
    """At most 8 rho retries (as tests/test_torch_mpc.py): a masked run makes
    all of them in every iteration."""
    prob = kuka_ee(num_time_steps=N, m_blocks=M, num_alpha=A)
    cfg = dataclasses.replace(prob.cfg, max_iter=max_iter, tol_cost=tol_cost,
                              pallas_riccati=True, max_bp_retries=8)
    return make_ilqr_solver(prob.plant, prob.cost, cfg)


def _cold_carry(solver, w):
    goal = ee_goal(GOAL, device="cpu")
    return solver._init_carry(torch.zeros(N, 14), torch.zeros(N, 7), goal, w,
                              None, None, None, True, False), goal


@pytest.mark.parametrize("case", list(CASES))
def test_masked_iteration_equals_early_exit(case):
    max_iter, tol_cost, iter_limit, weights = CASES[case]
    solver = _solver(max_iter, tol_cost)
    w = weights or CostWeights()
    cap = iter_limit or max_iter
    early, goal = _cold_carry(solver, w)
    reads = solver._drive(early, goal, w, cap)
    full, _ = _cold_carry(solver, w)
    with graphs.masked():
        for _ in range(max_iter):
            assert solver._iteration(full, goal, w, torch.tensor(cap)) == 0
    for name in _Carry.FIELDS:
        _same(getattr(full, name), getattr(early, name), name)
    iters = int(early.it) - 1
    if case == "stops_on_tol_cost":
        assert bool(early.done) and iters == 1 < max_iter
    elif case == "iter_limit_below_max_iter":
        assert iters == cap < max_iter and not bool(early.done)
    else:
        assert iters == max_iter and not bool(early.done)
    # one exit-flag read after each iteration the budget does not end, and
    # one per rho attempt
    retries = reads - min(iters, cap - 1) - iters
    assert (retries > 0) == (case == "rho_retries")


def _indefinite_backward_inputs(pallas):
    """tests/test_torch_riccati.py::test_rho_retry_matches_reference's case:
    an indefinite Huu that fails the first Cholesky tests."""
    rng = np.random.default_rng(0)
    n, m, nm = 3, 2, 5
    f32 = np.float32
    AB = rng.normal(0, 0.3, (N - 1, n, nm)).astype(f32)
    C = rng.normal(0, 0.3, (N, nm, nm)).astype(f32)
    H = np.einsum("kij,klj->kil", C, C) + np.eye(nm, dtype=f32)
    H[:, n:, n:] -= 3.0 * np.eye(m, dtype=f32)
    g = rng.normal(0, 0.5, (N, nm)).astype(f32)
    Cp = rng.normal(0, 0.3, (N, n, n)).astype(f32)
    Pp = np.einsum("kij,klj->kil", Cp, Cp) + np.eye(n, dtype=f32)
    pp = rng.normal(0, 0.5, (N, n)).astype(f32)
    d = rng.normal(0, 0.1, (N, n)).astype(f32)
    x = rng.normal(0, 0.5, (N, n)).astype(f32)
    xp2 = x + rng.normal(0, 0.05, (N, n)).astype(f32)
    cfg_ref = RefConfig(num_time_steps=N, total_time=0.5, m_blocks_b=4, m_blocks_f=2,
                        num_alpha=4, state_reg=True, pallas_riccati=False)
    cfg = dataclasses.replace(interop.solver_config(cfg_ref), pallas_riccati=pallas)
    return cfg_ref, cfg, (AB, H, g, Pp, pp, d, x, xp2)


@pytest.mark.parametrize("pallas", [False, True])
def test_masked_retry_matches_reference(pallas):
    """All max_bp_retries trips of the retry run, each committed under
    fail & tries < max: rho, drho, fail and K land where the reference's
    early-exit `lax.while_loop` does (tolerances: test_torch_riccati.py)."""
    cfg_ref, cfg, args = _indefinite_backward_inputs(pallas)
    ref = ref_backward_pass(cfg_ref, *(jnp.asarray(a) for a in args),
                            jnp.asarray(0.1, jnp.float32), jnp.asarray(1.0, jnp.float32))
    t = [torch.as_tensor(a) for a in args]
    with graphs.masked():
        out = backward_pass(cfg, *t, torch.tensor(0.1), torch.tensor(1.0))
    early = backward_pass(cfg, *t, torch.tensor(0.1), torch.tensor(1.0))
    assert out.host_syncs == 0 and early.host_syncs > 1
    assert float(ref.rho) > 0.1 and not bool(ref.fail) and not bool(out.fail)
    np.testing.assert_allclose(float(out.rho), float(ref.rho), rtol=1e-6)
    np.testing.assert_allclose(float(out.drho), float(ref.drho), rtol=1e-6)
    np.testing.assert_allclose(out.K.numpy(), np.asarray(ref.K), rtol=2e-4, atol=2e-5)
    for a, b in zip(out, early):
        if isinstance(a, torch.Tensor):
            _same(a, b)


def test_graph_route_of_the_solver():
    """The solver's graph route (one "capture", replays): the host route's
    solve bit for bit; a new iter_limit, goal or weight value takes effect
    without a new capture (the weights are a tensor the graph loads); a
    caller's outputs are never overwritten by the next call."""
    solver = _solver(3, 0.0)
    x0, u0 = torch.zeros(N, 14), torch.zeros(N, 7)
    goal, goal2 = ee_goal(GOAL, device="cpu"), ee_goal((0.35, -0.25, 0.85), device="cpu")
    w3 = CostWeights(r_ee=1e-3)
    want = [solver(x0, u0, g, wt, initial_rollout=True, iter_limit=il)
            for g, wt, il in ((goal, None, None), (goal2, None, 2), (goal, w3, None))]
    assert solver.host_syncs > 0
    with graphs.emulate():
        first = solver(x0, u0, goal, initial_rollout=True)
        kept = [t.clone() for t in first if isinstance(t, torch.Tensor)]
        second = solver(x0, u0, goal2, initial_rollout=True, iter_limit=2)
        assert solver.host_syncs == 0 and len(solver.graphs) == 1
        third = solver(x0, u0, goal, w3, initial_rollout=True)
        assert len(solver.graphs) == 1
    assert not torch.equal(third.J_trace, first.J_trace)
    for got, ref in zip((first, second, third), want):
        for name, a in got._asdict().items():
            if isinstance(a, torch.Tensor):
                _same(a, getattr(ref, name), name)
    assert int(second.iters) == 2 and int(first.iters) == 3
    for a, b in zip([t for t in first if isinstance(t, torch.Tensor)], kept):
        _same(a, b)


@pytest.mark.parametrize("x0", ["start", "nan"])
def test_graph_route_of_the_mpc_step_and_loop(x0, monkeypatch):
    """Two control steps of the closed loop (from a NaN plant state every
    solve fails and the reset fires) and one MPC step through their graph
    routes, with goals loaded one step at a time: the host route's results
    bit for bit, and no host reads."""
    monkeypatch.setattr(device_loop, "STEPS_PER_LOAD", 1)
    prob = kuka_ee(num_time_steps=N, m_blocks=M, num_alpha=A)
    cfg = dataclasses.replace(prob.cfg, pallas_riccati=True, max_bp_retries=8)
    ctrl = driver.MPCController(prob.plant, prob.cost, cfg, driver.MPCConfig(
        max_iters_per_solve=2, solves_to_reset=2, zero_controls_on_reset=True))
    x_init = np.zeros(14, np.float32)
    x_init[1], x_init[3], x_init[5] = np.pi / 4, -np.pi / 4, np.pi / 4
    w = fig8_weights()
    goal0 = ee_goal((0.0, -0.55, 0.35), x_target=x_init, device="cpu")
    st = ctrl.init_state(torch.as_tensor(x_init), goal=goal0, weights=w, warmup_iters=2)
    run = device_loop.make_device_mpc_loop(ctrl, sim_rate_hz=200.0, control_period_s=0.02)
    xs = torch.as_tensor(x_init if x0 == "start" else np.full(14, np.nan, np.float32))
    goals = {k: torch.stack([v] * 2) for k, v in goal0.items()}
    goals["ee_goal"] = goals["ee_goal"] + torch.linspace(0, 0.02, 2)[:, None]
    host = run(st, xs, 0.0, goals, w)
    host_step = ctrl.step(st, xs, 0.01, goal0, w)
    assert host.host_syncs > 0 and ctrl.host_syncs > 0
    with graphs.emulate():
        got = run(st, xs, 0.0, goals, w)
        got_step = ctrl.step(st, xs, 0.01, goal0, w)
        assert ctrl.host_syncs == 0
    assert got.host_syncs == 0
    for name in ("x", "ee_err", "J", "accepted", "ok"):
        _same(getattr(got, name), getattr(host, name), name)
    for a, b in zip(got.state, host.state):
        _same(a, b)
    for a, b in zip(got_step[0] + got_step[1], host_step[0] + host_step[1]):
        _same(a, b)
    if x0 == "nan":
        assert not got.ok.any() and int(got.state.fails) == 0   # reset at step 2
        assert not got.state.P.any() and not got.state.u.any()
