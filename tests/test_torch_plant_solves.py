"""The WAFR example's pendulum, cart-pole, quadrotor and joint-space Kuka
problems solved by the port against the JAX package's `ilqr_solve` from the
same inputs (CPU), at a small size: N = 16, 2 blocks, 4 alphas; plus one
finite-difference solve and the pendulum's MPC step and device loop.

Start states and goals are those of the JAX package's own uses
(tests/test_solver.py, examples/wafr_ilqr.py).  With `pallas_riccati` the
port's backward sweep is its Riccati op (the kernel's plain version on CPU
tensors) and the JAX side's is its Pallas kernel in interpret mode, as the
JAX package's own tests run it, for the pendulum and the cart-pole; for the
quadrotor and the Kuka the JAX side keeps its plain scan (its interpret-mode
kernel took 404 s to compile at n = 12, m = 4, and more than 2 minutes and
20 GB at n = 14, m = 7, on the CPU, measured; the JAX package's tests hold
that kernel equal to its scan, tests/test_pallas_riccati.py).

What is held, and why:
  * pendulum and cart-pole run the same expressions on both sides: the
    alpha traces are equal over the whole solve and J within J_RTOL_EXACT;
  * the quadrotor's backward pass is ill-conditioned: a one-ulp change of
    its AB moves the gains K by more than 0.1 % (held below, on the port's
    own backward pass), and its Euler-rate solve is W^-1 in closed form
    against JAX's LU, so the two packages' alpha traces part after a few
    iterations (at iteration 5 here, measured); the first QUAD_ITERS
    iterations are held, J within J_RTOL_CORES;
  * the Kuka runs the port's scalar-channel core against the JAX package's
    spatial-algebra CPU core (its scalar-channel core's step Jacobian takes
    minutes to compile on the CPU): float32 rounding of two different
    dynamics, J within J_RTOL_CORES as tests/test_torch_solver.py holds the
    Kuka EE solve; the alphas are equal over the KUKA_ITERS iterations (the
    third and later reject on both sides).  Paths would part first where two
    line-search candidates lie within that rounding of each other.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_ddp_tpu import presets as ref_presets
from parallel_ddp_tpu.mpc import driver as ref_driver
from parallel_ddp_tpu.mpc.device_loop import make_device_mpc_loop as ref_make_loop
from parallel_ddp_tpu.solver import ilqr_solve as ref_ilqr_solve
from parallel_ddp_tpu.solver import make_ilqr_solver as ref_make_solver
from parallel_ddp_tpu_torch import interop, presets
from parallel_ddp_tpu_torch.config import weights_of
from parallel_ddp_tpu_torch.mpc import driver
from parallel_ddp_tpu_torch.mpc.device_loop import make_device_mpc_loop
from parallel_ddp_tpu_torch.parallel.backward import backward_pass
from parallel_ddp_tpu_torch.solver import _derivatives, make_ilqr_solver

N, M, A = 16, 2, 4
J_RTOL_EXACT = 1e-5
J_RTOL_CORES = 2e-3
QUAD_ITERS = 4
KUKA_ITERS = 6
# examples/wafr_ilqr.py:44-48: the Kuka's goal and its start-state spread
KUKA_GOAL = [-0.5, 1.0, -0.3, 0.5, 0.7, 0.7, 0.0] + [0.0] * 7
KUKA_SIG = np.concatenate([np.full(7, 1.0), np.full(7, 0.5)])


def _case(name):
    """(preset name, preset kwargs, x0, u0, goal, max_iter, J rtol)."""
    if name == "pendulum":
        return ("pendulum_swingup", dict(total_time=1.0), np.zeros((N, 2)), np.zeros((N, 1)),
                [np.pi, 0.0], 12, J_RTOL_EXACT)
    if name == "cartpole":
        return ("cartpole_swingup", dict(total_time=1.0), np.zeros((N, 4)), np.zeros((N, 1)),
                [0.0, np.pi, 0.0, 0.0], 8, J_RTOL_EXACT)
    if name == "quadrotor":
        hover = -9.81 * 0.5 / 4.0      # per-rotor thrust balancing gravity
        return ("quadrotor_task", dict(total_time=1.0), np.zeros((N, 12)),
                np.full((N, 4), -hover), [1.0, 1.0, 0.5] + [0.0] * 9, QUAD_ITERS, J_RTOL_CORES)
    x_start = KUKA_SIG * np.random.default_rng(0).normal(0, 1.0, 14)
    return ("kuka_joint", {}, np.tile(x_start, (N, 1)), np.zeros((N, 7)), KUKA_GOAL, KUKA_ITERS,
            J_RTOL_CORES)


def _f32(a):
    return np.asarray(a, np.float32)


@functools.lru_cache(maxsize=None)
def _reference(name, pallas):
    preset, kw, x0, u0, goal, iters, _ = _case(name)
    prob = getattr(ref_presets, preset)(num_time_steps=N, m_blocks=M, num_alpha=A, **kw)
    cfg = dataclasses.replace(prob.cfg, max_iter=iters,
                              pallas_riccati=pallas and name in ("pendulum", "cartpole"))
    out = ref_ilqr_solve(prob.plant, prob.cost, cfg, jnp.asarray(_f32(x0)),
                         jnp.asarray(_f32(u0)), jnp.asarray(_f32(goal)), initial_rollout=True)
    return cfg, jax.device_get(out)


def _port(name, pallas, core="soa"):
    preset, kw, x0, u0, goal, iters, _ = _case(name)
    if name == "kuka":
        kw = dict(kw, core=core)
    prob = getattr(presets, preset)(num_time_steps=N, m_blocks=M, num_alpha=A, **kw)
    cfg_ref = _reference(name, pallas)[0]
    cfg = dataclasses.replace(interop.solver_config(cfg_ref), pallas_riccati=pallas)
    assert cfg == dataclasses.replace(prob.cfg, max_iter=iters, pallas_riccati=pallas)
    return prob, cfg, make_ilqr_solver(prob.plant, prob.cost, cfg)


def _traces(out):
    it = int(out.iters)
    return (np.asarray(out.J_trace)[: it + 1].astype(np.float64),
            np.asarray(out.alpha_trace)[: it + 1])


@pytest.mark.parametrize("pallas", [False, True], ids=["scan", "riccati_op"])
@pytest.mark.parametrize("name", ["pendulum", "cartpole", "quadrotor", "kuka"])
def test_solve_matches_jax(name, pallas):
    """The port's solve against the JAX package's from the same start: the
    same iterations and alphas, J within the case's rtol at every iteration;
    the Kuka's pallas case runs the port's kernel core (its plain versions
    on the CPU), the scan case its core without kernel hooks."""
    _, ref = _reference(name, pallas)
    _, _, x0, u0, goal, iters, rtol = _case(name)
    _, _, solver = _port(name, pallas, core="cuda" if pallas else "soa")
    out = solver(torch.as_tensor(_f32(x0)), torch.as_tensor(_f32(u0)),
                 interop.goal(jnp.asarray(_f32(goal))), initial_rollout=True)
    assert int(out.iters) == int(ref.iters)
    oj, oa = _traces(out)
    rj, ra = _traces(ref)
    np.testing.assert_array_equal(oa, ra)
    np.testing.assert_allclose(oj, rj, rtol=rtol)
    assert bool(out.converged) == bool(ref.converged)
    np.testing.assert_allclose(float(out.max_defect), float(ref.max_defect),
                               rtol=max(rtol, 1e-4), atol=1e-6)
    assert np.any(oa[1:] >= 0) and oj[-1] < oj[0]             # something accepted
    if name in ("pendulum", "cartpole"):                      # converged inside the budget
        assert bool(out.converged) and int(out.iters) < iters


def test_quadrotor_backward_pass_is_ill_conditioned():
    """Why the quadrotor's traces part from the JAX package's: at the solve's
    iterate after 2 iterations, moving every AB entry by one float32 ulp
    moves the backward pass's gains K by more than 0.1 %."""
    prob, cfg, _ = _port("quadrotor", False)
    _, _, x0, u0, goal, _, _ = _case("quadrotor")
    solver = make_ilqr_solver(prob.plant, prob.cost, dataclasses.replace(cfg, max_iter=2))
    g = torch.as_tensor(_f32(goal))
    st = solver(torch.as_tensor(_f32(x0)), torch.as_tensor(_f32(u0)), g, initial_rollout=True)
    np.testing.assert_array_equal(_traces(st)[1], _traces(_reference("quadrotor", False)[1])[1][:3])
    AB, H, gq = _derivatives(cfg, solver.step_jac, prob.cost.quad, st.x, st.u, g,
                             weights_of(None, st.x))

    def gains(ab):
        one = lambda t: t[None]
        return backward_pass(cfg, one(ab), one(H), one(gq), one(st.P), one(st.p), one(st.d),
                             one(st.x), one(st.x), st.rho.reshape(1), torch.ones(1)).K[0]

    K = gains(AB)
    K1 = gains(torch.nextafter(AB, torch.full_like(AB, np.inf)))
    assert float((K1 - K).abs().max()) > 1e-3 * float(K.abs().max())


def test_finite_difference_solve_matches_jax():
    """tests/test_options.py's FD solve (pendulum, N = 32, 40 iterations).
    The two packages' FD Jacobians differ by ~ulp(|x'|) / eps ~ 1e-3 of their
    scale (tests/test_torch_plants.py), so the J traces are held within
    FD_J_RTOL and the alphas at every iteration where the reference's step
    gains more than FD_TIE of J (ten times that noise); below it two
    candidates can be as close as the noise, and the paths part (at
    iteration 8 here, measured).  After the parting the two are held to
    the same end: final J within FD_J_RTOL and tests/test_options.py's bar
    on the final state."""
    FD_J_RTOL, FD_TIE = 5e-3, 1e-2
    kw = dict(num_time_steps=32, total_time=1.5, m_blocks=2, num_alpha=8)
    rp = ref_presets.pendulum_swingup(**kw)
    ref_cfg = dataclasses.replace(rp.cfg, use_finite_diff=True, max_iter=40)
    ref = jax.device_get(ref_make_solver(rp.plant, rp.cost, ref_cfg)(
        jnp.zeros((32, 2)), jnp.zeros((32, 1)), jnp.asarray([np.pi, 0.0]),
        initial_rollout=True))
    prob = presets.pendulum_swingup(**kw)
    cfg = interop.solver_config(ref_cfg)
    solver = make_ilqr_solver(prob.plant, prob.cost, cfg)
    assert getattr(solver.step_jac, "_is_batched", False)
    out = solver(torch.zeros(32, 2), torch.zeros(32, 1), torch.tensor([np.pi, 0.0]),
                 initial_rollout=True)
    (oj, oa), (rj, ra) = _traces(out), _traces(ref)
    gain = -np.diff(rj) / rj[:-1]
    held = 1 + int(np.argmin(gain > FD_TIE)) if np.any(gain <= FD_TIE) else len(rj)
    assert held >= 5                                  # the descent, where steps are large
    np.testing.assert_array_equal(oa[:held], ra[:held])
    np.testing.assert_allclose(oj[:held], rj[:held], rtol=FD_J_RTOL)
    np.testing.assert_allclose(float(out.J), float(ref.J), rtol=FD_J_RTOL)
    for x in (out.x, ref.x):
        assert abs(float(x[-1, 0]) - np.pi) < 0.15               # tests/test_options.py's bar


# kuka_joint's FD solve: the start moved by these many float32 ulps gives the
# rounding envelope; the JAX package's FD solve must stay within
# FD_ENVELOPE_FACTOR x that envelope (chip_smoke.py holds the card's FD solve
# against the CPU's the same way)
ULP_MOVES = (1, -1, 2, -2)
FD_ENVELOPE_FACTOR = 2.0
FD_KUKA_ITERS = 4


def _moved(x, k):
    """x moved k float32 ulps (up for k > 0, down for k < 0)."""
    for _ in range(abs(k)):
        x = np.nextafter(x, np.float32(np.inf if k > 0 else -np.inf))
    return x


def _envelope(base, moved):
    """The running largest relative J gap of the moved solves' traces to the
    base trace (each held at its last value past its end)."""
    k = len(base)
    pad = lambda j: np.concatenate([j[:k], np.full(max(0, k - len(j)), j[-1])])
    gaps = [np.abs(pad(j) - base) / np.abs(base) for j in moved]
    return np.maximum.accumulate(np.max(gaps, axis=0))


def test_kuka_finite_difference_solve_parts_within_rounding():
    """kuka_joint with finite differences (N = 16, FD_KUKA_ITERS iterations).
    Its FD Jacobian carries ~ulp(|x'|) / eps of rounding noise, times the
    mass matrix's conditioning, and the solve amplifies it: the port's own
    FD solve from a start moved by one or two ulps (ULP_MOVES) parts from it
    by more than 1e-2 of J within two iterations (measured: 5.8e-2 at
    iteration 1, 2.1e-1 at 2; one of them takes another step at iteration
    2).  The JAX package's FD solve on its spatial-algebra core is a third
    rounding of the same solve: J0 within J_RTOL_CORES, its first step one
    that the moved solves take, and its J within FD_ENVELOPE_FACTOR x the
    moved solves' envelope at every iteration (measured: at most 0.53 x)."""
    _, _, x0, u0, goal, _, _ = _case("kuka")
    rp = ref_presets.kuka_joint(num_time_steps=N, m_blocks=M, num_alpha=A)
    ref_cfg = dataclasses.replace(rp.cfg, use_finite_diff=True, max_iter=FD_KUKA_ITERS)
    ref = jax.device_get(ref_make_solver(rp.plant, rp.cost, ref_cfg)(
        jnp.asarray(_f32(x0)), jnp.asarray(_f32(u0)), jnp.asarray(_f32(goal)),
        initial_rollout=True))
    prob = presets.kuka_joint(num_time_steps=N, m_blocks=M, num_alpha=A)
    cfg = interop.solver_config(ref_cfg)
    assert cfg == dataclasses.replace(prob.cfg, use_finite_diff=True, max_iter=FD_KUKA_ITERS)
    solver = make_ilqr_solver(prob.plant, prob.cost, cfg)
    solve = lambda x: _traces(solver(torch.as_tensor(x), torch.as_tensor(_f32(u0)),
                                     torch.as_tensor(_f32(goal)), initial_rollout=True))
    (oj, oa), (rj, ra) = solve(_f32(x0)), _traces(ref)
    moved = [solve(_moved(_f32(x0), k)) for k in ULP_MOVES]
    env = _envelope(oj, [j for j, _ in moved])
    assert env[2] > 1e-2                        # the amplification: percents of J from ulps
    np.testing.assert_allclose(rj[0], oj[0], rtol=J_RTOL_CORES)
    assert ra[1] in {oa[1]} | {a[1] for _, a in moved}
    k = min(len(oj), len(rj))
    gap = np.abs(rj[:k] - oj[:k]) / np.abs(oj[:k])
    assert np.all(gap <= FD_ENVELOPE_FACTOR * np.maximum(env[:k], J_RTOL_EXACT)), (gap, env)


# the pendulum MPC setup of tests/test_mpc.py (N = 32 over 1 s, 2 blocks,
# 8 alphas, RK3, rho 10; 3 iterations a solve; 200 Hz RK3 plant, 0.05 s a
# control step), shortened
MPC_N, MPC_ITERS, MPC_STEPS = 32, 3, 6
MPC_X0 = np.asarray([np.pi - 0.4, 0.3], np.float32)
MPC_J_RTOL, MPC_X_ATOL = 1e-4, 1e-4


def _pendulum_cfg():
    return dict(num_time_steps=MPC_N, total_time=1.0, m_blocks=2, num_alpha=8)


@functools.lru_cache(maxsize=None)
def _reference_mpc():
    rp = ref_presets.pendulum_swingup(**_pendulum_cfg())
    ctrl = ref_driver.MPCController(rp.plant, rp.cost, rp.cfg,
                                    ref_driver.MPCConfig(max_iters_per_solve=MPC_ITERS))
    goal = jnp.asarray([np.pi, 0.0])
    st = ctrl.init_state(MPC_X0, t0=0.0, goal=goal)
    steps, s = [], st
    for i in range(3):
        s, info = ctrl.step(s, MPC_X0 + 0.01 * i, 0.05 * (i + 1), goal)
        steps.append(jax.device_get((s, info)))
    loop = ref_make_loop(ctrl, sim_rate_hz=200.0, control_period_s=0.05, sim_integrator=3)
    res = loop(st, MPC_X0, 0.0, jnp.tile(goal[None], (MPC_STEPS, 1)))
    return jax.device_get(st), steps, jax.device_get(res)


def _port_controller():
    prob = presets.pendulum_swingup(**_pendulum_cfg())
    cfg = dataclasses.replace(prob.cfg, pallas_riccati=True)
    return driver.MPCController(prob.plant, prob.cost, cfg,
                                driver.MPCConfig(max_iters_per_solve=MPC_ITERS))


def test_pendulum_mpc_steps_match_jax():
    """init_state's warm-up solve and three MPC steps (a new measured state
    and clock each) against the JAX controller's."""
    ref_st, ref_steps, _ = _reference_mpc()
    ctrl = _port_controller()
    goal = torch.tensor([np.pi, 0.0])
    st = ctrl.init_state(torch.as_tensor(MPC_X0), t0=0.0, goal=goal)
    np.testing.assert_allclose(st.x.numpy(), ref_st.x, rtol=0, atol=MPC_X_ATOL)
    for i, (ref_s, ref_info) in enumerate(ref_steps):
        st, info = ctrl.step(st, torch.as_tensor(MPC_X0 + 0.01 * i), 0.05 * (i + 1), goal)
        assert bool(info.accepted) == bool(ref_info.accepted)
        assert int(info.iters) == int(ref_info.iters)
        assert int(info.shift_steps) == int(ref_info.shift_steps)
        np.testing.assert_allclose(float(info.J), float(ref_info.J), rtol=MPC_J_RTOL)
        np.testing.assert_allclose(st.x.numpy(), ref_s.x, rtol=0, atol=MPC_X_ATOL)
        np.testing.assert_allclose(st.u.numpy(), ref_s.u, rtol=0, atol=10 * MPC_X_ATOL)
        assert float(st.t0) == pytest.approx(float(ref_s.t0))


def test_pendulum_device_loop_matches_jax():
    """MPC_STEPS control steps of the device loop (warm start, 3-iteration
    re-solve, 10 RK3 plant substeps under the control law): the same
    accept and ok decisions, J, states and tracking error close to the
    JAX loop's."""
    ref_st, _, want = _reference_mpc()
    ctrl = _port_controller()
    run = make_device_mpc_loop(ctrl, sim_rate_hz=200.0, control_period_s=0.05, sim_integrator=3)
    goals = torch.tensor([np.pi, 0.0]).expand(MPC_STEPS, 2)
    got = run(interop.mpc_state(ref_st), torch.as_tensor(MPC_X0), 0.0, goals)
    np.testing.assert_array_equal(got.accepted.numpy(), want.accepted)
    np.testing.assert_array_equal(got.ok.numpy(), want.ok)
    np.testing.assert_allclose(got.J.numpy(), want.J, rtol=MPC_J_RTOL)
    np.testing.assert_allclose(got.x.numpy(), want.x, rtol=0, atol=MPC_X_ATOL)
    np.testing.assert_allclose(got.ee_err.numpy(), want.ee_err, rtol=0, atol=MPC_X_ATOL)
    assert got.host_syncs > 0
