"""The port's MPC layer (parallel_ddp_tpu_torch/mpc/) against the reference's
on the same seeded inputs, at kuka_ee(num_time_steps=16, num_alpha=4).

The reference runs the spatial-algebra `rbd` core (as tests/test_torch_solver.py
does: the `soa` core's step Jacobian takes minutes to compile on the CPU); the
port runs its main-path "cuda" core, whose ops use their plain versions on
CPU tensors.  The two cores differ in float32 rounding only, so:
  * pure index/time logic (`_shift`, the iteration cap, the timing model)
    agrees exactly;
  * dynamics-driven values (warm-start rollouts, the simulator, the control
    law) agree within ROLL_TOL, float32 rounding over at most 15 Euler steps;
  * the closed loop takes the same accept and ok decisions at every step,
    with J within J_RTOL (as tests/test_torch_solver.py) and the EE error
    within ERR_ATOL metres.
The reference's programs are built once per module (lru_cache)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_ddp_tpu.mpc import driver as ref_driver
from parallel_ddp_tpu.mpc.device_loop import get_hardware_controls_jax
from parallel_ddp_tpu.mpc.device_loop import make_device_mpc_loop as ref_make_loop
from parallel_ddp_tpu.mpc.simulator import PlantSimulator as RefSimulator
from parallel_ddp_tpu.mpc.simulator import run_lockstep_mpc as ref_run_lockstep
from parallel_ddp_tpu.presets import fig8_weights as ref_fig8_weights
from parallel_ddp_tpu.presets import kuka_ee as ref_kuka_ee
from parallel_ddp_tpu_torch import interop
from parallel_ddp_tpu_torch.mpc import controls, driver
from parallel_ddp_tpu_torch.mpc.device_loop import get_hardware_controls, make_device_mpc_loop
from parallel_ddp_tpu_torch.mpc.simulator import PlantSimulator, run_lockstep_mpc
from parallel_ddp_tpu_torch.presets import fig8_weights, figure8_goal, kuka_ee

N, A = 16, 4
ROLL_TOL = 2e-5
J_RTOL = 2e-3
ERR_ATOL = 1e-4
X_INIT = np.zeros(14, np.float32)
X_INIT[1], X_INIT[3], X_INIT[5] = np.pi / 4, -np.pi / 4, np.pi / 4
LOOP_MPC = dict(max_iters_per_solve=3, solves_to_reset=2, zero_controls_on_reset=True)
SIM_RATE, CONTROL_PERIOD, STEPS = 200.0, 0.02, 4
LOCKSTEP_STEPS = 2


def _controllers(m_blocks, **mpc):
    """(reference, port) controllers on the same configuration.  At most 8
    rho retries per backward pass: a failing solve (the NaN case below) makes
    them all, and each is a host round trip in the port."""
    ref = ref_kuka_ee(num_time_steps=N, m_blocks=m_blocks, num_alpha=A)
    assert "rbd" in ref.plant.name
    ref_cfg = dataclasses.replace(ref.cfg, max_bp_retries=8)
    prob = kuka_ee(num_time_steps=N, m_blocks=m_blocks, num_alpha=A)
    cfg = dataclasses.replace(interop.solver_config(ref_cfg), pallas_riccati=True)
    return (ref_driver.MPCController(ref.plant, ref.cost, ref_cfg, ref_driver.MPCConfig(**mpc)),
            driver.MPCController(prob.plant, prob.cost, cfg, driver.MPCConfig(**mpc)))


def _random_state(rng, t0=0.0, fails=0):
    """A reference MPCState of seeded arrays (moderate torques and gains)."""
    f = lambda shape, s: jnp.asarray(rng.normal(0, s, shape).astype(np.float32))
    return ref_driver.MPCState(
        x=f((N, 14), 0.3), u=f((N, 7), 1.0), K=f((N, 7, 14), 0.1), P=f((N, 14, 14), 1.0),
        p=f((N, 14), 1.0), d=f((N, 14), 0.01), t0=jnp.asarray(t0, jnp.float32),
        fails=jnp.asarray(fails, jnp.int32))


def _close(got, ref, tol=ROLL_TOL, name=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * max(np.abs(ref).max(), 1.0),
                               err_msg=name)


@pytest.mark.parametrize("s", [0, 3, 15, 20])
def test_shift_matches_reference(s):
    a = np.random.default_rng(s).normal(size=(N, 3, 2)).astype(np.float32)
    ref = np.asarray(ref_driver._shift(jnp.asarray(a), jnp.asarray(s, jnp.int32)))
    np.testing.assert_array_equal(driver._shift(torch.as_tensor(a), s).numpy(), ref)
    np.testing.assert_array_equal(
        driver._shift(torch.as_tensor(a), torch.tensor(s, dtype=torch.int32)).numpy(), ref)


def test_iteration_cap_and_timing_model():
    """`_resolve_iter_limit` and `calibrate_timing` give the reference's
    numbers on the same inputs."""
    ref, port = _controllers(2, max_iters_per_solve=6)
    cases = [(None, None), (3, None), (10, None), (0, None), (None, 20.0), (4, 9.0)]
    for it, tl in cases:
        assert port._resolve_iter_limit(it, tl) == int(ref._resolve_iter_limit(it, tl))
    samples = [(30.0, 6), (12.0, 2), (11.0, 2), (25.0, 6), (0.0, 0), (20.0, 4)]
    for ms, iters in samples:
        ref.calibrate_timing(ms, iters)
        port.calibrate_timing(ms, iters)
        assert port.per_iter_ms == pytest.approx(ref.per_iter_ms)
        assert port.overhead_ms == pytest.approx(ref.overhead_ms)
        for it, tl in cases:
            assert port._resolve_iter_limit(it, tl) == int(ref._resolve_iter_limit(it, tl))
    # one iteration count only: wall / iters, no overhead
    ref1, port1 = _controllers(2)
    ref1.calibrate_timing(9.0, 3)
    port1.calibrate_timing(9.0, 3)
    assert (port1.per_iter_ms, port1.overhead_ms) == (ref1.per_iter_ms, ref1.overhead_ms) == (3.0, 0.0)


@pytest.mark.parametrize("full_rollout", [True, False], ids=["full", "blocks"])
def test_warm_start_matches_reference(full_rollout):
    """Shift by s = 5 and re-roll from a measured state.  With 4 blocks of 4
    the boundaries are k = 3, 7, 11; 11 + 5 lands in the ZOH tail, so the
    block branch writes the tail defect there and the exact defect at 3."""
    ref, port = _controllers(4, full_rollout=full_rollout)
    rng = np.random.default_rng(1)
    st = _random_state(rng)
    x_act = rng.normal(0, 0.3, 14).astype(np.float32)
    s = 5
    want = ref._warm_start(st, jnp.asarray(x_act), jnp.asarray(s, jnp.int32))
    got = port._warm_start(interop.mpc_state(st), torch.as_tensor(x_act),
                           torch.tensor(s, dtype=torch.int32))
    for name, g, r in zip(("x", "u", "K", "P", "p", "d"), got, want):
        _close(g, r, name=name)
    d = got[5].numpy()
    if full_rollout:
        assert not d.any()
    else:
        shifted = np.asarray(st.d)[np.minimum(np.arange(N) + s, N - 1)]
        rewritten = [3, 11]          # the exact first boundary and the tail one
        assert (d[rewritten] != shifted[rewritten]).all(axis=1).all()
        keep = [k for k in range(N) if k not in rewritten]
        np.testing.assert_array_equal(d[keep], shifted[keep])


def test_hardware_controls_match_reference():
    """The tensor control law against the reference's traced twin, inside,
    before and past the trajectory (clamped), with and without feedback; and
    against the numpy runner where that one is defined."""
    rng = np.random.default_rng(2)
    tx, tu = rng.normal(size=(N, 14)).astype(np.float32), rng.normal(size=(N, 7)).astype(np.float32)
    tk = rng.normal(0, 0.1, (N, 7, 14)).astype(np.float32)
    xm = rng.normal(size=14).astype(np.float32)
    t0, dt = 0.25, 0.5 / 15
    for t in (0.25, 0.2617, 0.4, 0.74, 0.9, 0.1):
        for fb in (True, False):
            want = get_hardware_controls_jax(jnp.asarray(tx), jnp.asarray(tu), jnp.asarray(tk),
                                             jnp.float32(t0), dt, jnp.float32(t),
                                             jnp.asarray(xm), fb)
            got = get_hardware_controls(
                torch.as_tensor(tx), torch.as_tensor(tu), torch.as_tensor(tk),
                torch.tensor(t0), dt, torch.tensor(t, dtype=torch.float32),
                torch.as_tensor(xm), fb)
            _close(got, want, 1e-5, f"t={t} feedback={fb}")
            u_np, ok = controls.get_hardware_controls(
                controls.TrajHandoff(tx, tu, tk, t0, dt), t, xm, use_feedback=fb)
            assert ok == (t0 <= t < t0 + (N - 1) * dt)
            if ok:
                _close(got, u_np, 1e-5, f"numpy t={t}")


def test_plant_simulator_matches_reference():
    ref_plant = ref_kuka_ee(num_time_steps=N, m_blocks=2, num_alpha=A).plant
    plant = kuka_ee(num_time_steps=N, m_blocks=2, num_alpha=A).plant
    ref = RefSimulator(ref_plant, rate_hz=500.0, substeps=2, integrator=3)
    sim = PlantSimulator(plant, rate_hz=500.0, substeps=2, integrator=3, device="cpu")
    rng = np.random.default_rng(3)
    x = rng.normal(0, 0.5, 14).astype(np.float32)
    for _ in range(3):
        u = rng.normal(0, 5.0, 7).astype(np.float32)
        got, want = sim.step(x, u), ref.step(x, u)
        assert got.dtype == np.float32 and got.shape == (14,)
        _close(got, want, name="sim")
        x = want


def _loop_goals(lib):
    """STEPS goals along the figure-8, as the fig-8 benchmark builds them."""
    xyz = np.stack([figure8_goal((i + 1) * CONTROL_PERIOD)[0] for i in range(STEPS)])
    goals = {"ee_goal": np.concatenate([xyz, np.zeros_like(xyz)], 1).astype(np.float32),
             "x_target": np.tile(X_INIT, (STEPS, 1))}
    return {k: lib.asarray(v) for k, v in goals.items()}


def _start_state():
    """At rest at X_INIT with zero torques: dynamically exact in the
    gravity-compensated plant (zero defects)."""
    z = lambda *shape: jnp.zeros(shape, jnp.float32)
    return ref_driver.MPCState(
        x=jnp.tile(jnp.asarray(X_INIT), (N, 1)), u=z(N, 7), K=z(N, 7, 14), P=z(N, 14, 14),
        p=z(N, 14), d=z(N, 14), t0=jnp.float32(0.0), fails=jnp.int32(0))


@functools.lru_cache(maxsize=None)
def _reference_loops():
    """The reference's device loop from the start state and, with the same
    program, from a NaN plant state (every solve fails)."""
    ref, _ = _controllers(2, **LOOP_MPC)
    run = ref_make_loop(ref, sim_rate_hz=SIM_RATE, control_period_s=CONTROL_PERIOD)
    goals, w = _loop_goals(jnp), ref_fig8_weights()
    good = run(_start_state(), jnp.asarray(X_INIT), 0.0, goals, w)
    bad = run(_start_state(), jnp.full(14, jnp.nan, jnp.float32), 0.0, goals, w)
    return jax.device_get(good), jax.device_get(bad)


def _port_loop(x0, hook=True, steps=STEPS):
    _, port = _controllers(2, **LOOP_MPC)
    if not hook:      # the same plant without its simulation-chain op
        plant = dataclasses.replace(port.plant, sim_chain=None)
        port = driver.MPCController(plant, port.cost, port.cfg, port.mpc)
    run = make_device_mpc_loop(port, sim_rate_hz=SIM_RATE, control_period_s=CONTROL_PERIOD)
    goals = {k: torch.as_tensor(v)[:steps] for k, v in _loop_goals(np).items()}
    return run(interop.mpc_state(_start_state()), torch.as_tensor(x0), 0.0, goals,
               fig8_weights())


def test_closed_loop_matches_reference():
    """STEPS control steps of the closed loop: warm start, 3-iteration
    re-solve, 4 plant substeps at 200 Hz; the shift index reaches 1."""
    want, _ = _reference_loops()
    got = _port_loop(X_INIT)
    np.testing.assert_array_equal(got.accepted.numpy(), np.asarray(want.accepted))
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(want.ok))
    assert got.ok.all()
    np.testing.assert_allclose(got.J.numpy(), np.asarray(want.J), rtol=J_RTOL)
    np.testing.assert_allclose(got.ee_err.numpy(), np.asarray(want.ee_err), rtol=0, atol=ERR_ATOL)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=1e-3)
    assert float(want.state.t0) > 0                               # shifted
    assert float(got.state.t0) == pytest.approx(float(want.state.t0))
    assert got.host_syncs > 0


def test_closed_loop_without_chain_hook_is_the_same():
    """A plant that ships no `sim_chain` still runs, through the loops over
    `make_step`; on CPU tensors the Kuka's chain is those loops, so two
    control steps of the closed loop agree bit for bit."""
    with_hook, without = _port_loop(X_INIT, steps=2), _port_loop(X_INIT, hook=False, steps=2)
    for name in ("x", "ee_err", "J", "accepted", "ok"):
        assert torch.equal(getattr(with_hook, name), getattr(without, name)), name
    for a, b in zip(with_hook.state, without.state):
        assert torch.equal(a, b)


@pytest.mark.parametrize("substeps", [1, 3])
def test_plant_simulator_substeps_are_the_step_loop(substeps):
    """`PlantSimulator.step` holds the control over its substeps: one chain
    call, equal to the step repeated."""
    plant = kuka_ee(num_time_steps=N, m_blocks=2, num_alpha=A).plant
    sim = PlantSimulator(plant, rate_hz=500.0, substeps=substeps, integrator=2, device="cpu")
    rng = np.random.default_rng(substeps)
    x, u = rng.normal(0, 0.5, 14).astype(np.float32), rng.normal(0, 5.0, 7).astype(np.float32)
    from parallel_ddp_tpu_torch.ops.integrators import make_step
    step = make_step(plant, 2, (1.0 / 500.0) / substeps)
    want = torch.as_tensor(x)
    for _ in range(substeps):
        want = step(want, torch.as_tensor(u))
    np.testing.assert_array_equal(sim.step(x, u), want.numpy())


def test_closed_loop_failure_reset_matches_reference():
    """A NaN plant state fails every solve: the failure counter counts up to
    solves_to_reset = 2 and resets, zeroing P, p, u and K
    (zero_controls_on_reset), exactly as in the reference."""
    _, want = _reference_loops()
    got = _port_loop(np.full(14, np.nan, np.float32))
    assert not np.asarray(want.ok).any() and not got.ok.any()
    np.testing.assert_array_equal(got.accepted.numpy(), np.asarray(want.accepted))
    assert int(got.state.fails) == int(want.state.fails) == 0     # reset at step 4
    for name in ("P", "p", "u", "K"):
        assert not getattr(got.state, name).any(), name
        assert not np.asarray(getattr(want.state, name)).any(), name


def _lockstep_goal_fn(goals):
    """goal_fn(t) of the lockstep loops: the closed-loop tests' goal of the
    control step at t."""
    return lambda t: {k: v[int(round(t / CONTROL_PERIOD))] for k, v in goals.items()}


@functools.lru_cache(maxsize=None)
def _reference_lockstep():
    """The reference's lockstep loop for LOCKSTEP_STEPS control steps from
    the closed-loop tests' start state (its cold-start solve replaced)."""
    ref, _ = _controllers(2, **LOOP_MPC)
    ref.init_state = lambda *args, **kwargs: _start_state()
    sim = RefSimulator(ref.plant, rate_hz=SIM_RATE, integrator=1)
    return ref_run_lockstep(ref, sim, X_INIT, duration=LOCKSTEP_STEPS * CONTROL_PERIOD,
                            goal_fn=_lockstep_goal_fn(_loop_goals(jnp)),
                            control_period=CONTROL_PERIOD, weights=ref_fig8_weights())


@functools.lru_cache(maxsize=None)
def _port_lockstep():
    """(the port's lockstep result, its controller, its start state, its goals)
    for LOCKSTEP_STEPS control steps, started as `_reference_lockstep`."""
    _, port = _controllers(2, **LOOP_MPC)
    st = interop.mpc_state(_start_state())
    port.init_state = lambda *args, **kwargs: st
    sim = PlantSimulator(port.plant, rate_hz=SIM_RATE, integrator=1, device="cpu")
    goals = {k: torch.as_tensor(v) for k, v in _loop_goals(np).items()}
    got = run_lockstep_mpc(port, sim, X_INIT, duration=LOCKSTEP_STEPS * CONTROL_PERIOD,
                           goal_fn=_lockstep_goal_fn(goals), control_period=CONTROL_PERIOD,
                           weights=fig8_weights())
    return got, port, st, goals


def test_lockstep_loop_matches_reference():
    """The host-side lockstep loop (numpy trajectory runner between solves,
    `PlantSimulator` substeps) against the reference's `run_lockstep_mpc`
    from the same start state: the same solves, and the same times, plant
    states (recorded before each substep) and applied controls."""
    want = _reference_lockstep()
    got, _, _, _ = _port_lockstep()
    substeps = round(CONTROL_PERIOD * SIM_RATE)
    assert got.x.shape == want.x.shape == (LOCKSTEP_STEPS * substeps, 14)
    np.testing.assert_array_equal(got.accepted, want.accepted)
    np.testing.assert_allclose(got.J, want.J, rtol=J_RTOL)
    np.testing.assert_array_equal(got.t, want.t)
    np.testing.assert_allclose(got.x, want.x, rtol=0, atol=1e-3)
    _close(got.u, want.u, 1e-3, "applied controls")


def test_lockstep_loop_matches_device_loop():
    """The host-side lockstep loop against the port's device loop from the
    same start state (its cold-start solve replaced by the closed-loop tests'
    start): the same solves, and the same plant state at every control
    step's end."""
    got, port, st, goals = _port_lockstep()
    run = make_device_mpc_loop(port, sim_rate_hz=SIM_RATE, control_period_s=CONTROL_PERIOD)
    want = run(st, torch.as_tensor(X_INIT), 0.0,
               {k: v[:LOCKSTEP_STEPS] for k, v in goals.items()}, fig8_weights())
    np.testing.assert_array_equal(got.accepted, want.accepted.numpy())
    np.testing.assert_allclose(got.J, want.J.numpy(), rtol=1e-5)
    substeps = round(CONTROL_PERIOD * SIM_RATE)
    assert got.x.shape == (LOCKSTEP_STEPS * substeps, 14)
    # lockstep records the state before each substep; the device loop the
    # state after each control step
    np.testing.assert_allclose(got.x[substeps::substeps], want.x.numpy()[:-1], rtol=0, atol=1e-5)
