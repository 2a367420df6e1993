"""The port's simulation chains (parallel_ddp_tpu_torch/ops/cuda_sim_chain.py)
on CPU tensors — their plain versions — against the reference's `lax.scan`s
of its integrator step, on the same seeded inputs.

The reference runs the spatial-algebra `rbd` core (as tests/test_torch_mpc.py
does; the `soa` core's step takes minutes to compile on the CPU), the port its
"cuda" core, whose ops use their plain versions on CPU tensors.  The two
cores differ in float32 rounding only: a chain of at most 10 steps agrees
within CHAIN_TOL.  Inside the port the chain replaces Python loops over
`make_step`; on CPU tensors it must reproduce those loops bit for bit."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_ddp_tpu.mpc.device_loop import get_hardware_controls_jax
from parallel_ddp_tpu.ops.integrators import make_step as ref_make_step
from parallel_ddp_tpu.presets import kuka_ee as ref_kuka_ee
from parallel_ddp_tpu_torch import interop
from parallel_ddp_tpu_torch.mpc import driver
from parallel_ddp_tpu_torch.ops import cuda_sim_chain
from parallel_ddp_tpu_torch.ops.cuda_sim_chain import make_sim_chain
from parallel_ddp_tpu_torch.ops.integrators import make_step
from parallel_ddp_tpu_torch.presets import kuka_ee
from parallel_ddp_tpu_torch.solver import open_loop_rollout

N, A = 16, 4
DT = 0.5 / (N - 1)
SIM_DT = 0.001
CHAIN_TOL = 2e-5   # float32 rounding of two RBD cores over <= 10 integrator steps


@functools.lru_cache(maxsize=None)
def _plants():
    ref = ref_kuka_ee(num_time_steps=N, m_blocks=2, num_alpha=A).plant
    assert "rbd" in ref.name
    return ref, kuka_ee(num_time_steps=N, m_blocks=2, num_alpha=A).plant


def _close(got, ref, tol=CHAIN_TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * max(np.abs(ref).max(), 1.0))


@pytest.mark.parametrize("integrator", [1, 2, 3], ids=["euler", "midpoint", "rk3"])
def test_open_loop_matches_reference_scan(integrator):
    """Mode (a): 8 steps under given controls against a lax.scan of the
    reference's step; two lanes at once against each lane alone."""
    ref_plant, plant = _plants()
    rng = np.random.default_rng(integrator)
    x0 = rng.normal(0, 0.3, (2, 14)).astype(np.float32)
    u = rng.normal(0, 2.0, (2, 8, 7)).astype(np.float32)
    step = ref_make_step(ref_plant, integrator, DT)

    @jax.jit
    def scan(x, us):
        def body(xc, uc):
            xn = step(xc, uc)
            return xn, xn
        return jax.lax.scan(body, x, us)[1]

    chain = make_sim_chain(plant, integrator, DT)
    got = chain.open_loop(torch.as_tensor(x0), torch.as_tensor(u))
    assert got.shape == (2, 8, 14) and got.dtype == torch.float32
    for lane in range(2):
        _close(got[lane], scan(jnp.asarray(x0[lane]), jnp.asarray(u[lane])))
        alone = chain.open_loop(torch.as_tensor(x0[lane]), torch.as_tensor(u[lane]))
        torch.testing.assert_close(alone, got[lane], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("t0,t,feedback", [
    (0.25, 0.2617, True),     # inside the plan, crossing knots
    (0.25, 0.2617, False),    # open-loop controls only
    (0.0, 0.4995, True),      # runs off the plan's end: index and fraction clamp
    (0.3, 0.1, True),         # before the plan's start: clamped to row 0
], ids=["inside", "no-feedback", "end-clamp", "start-clamp"])
def test_runner_matches_reference_substep_scan(t0, t, feedback):
    """Mode (b): 10 plant substeps under the trajectory runner's control law
    against the reference's substep scan (mpc/device_loop.py)."""
    ref_plant, plant = _plants()
    rng = np.random.default_rng(5)
    tx = rng.normal(0, 0.3, (N, 14)).astype(np.float32)
    tu = rng.normal(0, 1.0, (N, 7)).astype(np.float32)
    tk = rng.normal(0, 0.1, (N, 7, 14)).astype(np.float32)
    x = rng.normal(0, 0.3, 14).astype(np.float32)
    sim_step = ref_make_step(ref_plant, 1, SIM_DT)

    @jax.jit
    def scan(x_sim, tt):
        def substep(c, _):
            xc, tc = c
            uc = get_hardware_controls_jax(jnp.asarray(tx), jnp.asarray(tu), jnp.asarray(tk),
                                           jnp.float32(t0), DT, tc, xc, feedback)
            xn = sim_step(xc, uc)
            return (xn, tc + SIM_DT), xn
        (_, t_end), xs = jax.lax.scan(substep, (x_sim, tt), None, length=10)
        return xs, t_end

    want_x, want_t = scan(jnp.asarray(x), jnp.float32(t))
    chain = make_sim_chain(plant, 1, SIM_DT)
    got_x, got_t = chain.runner(torch.as_tensor(tx), torch.as_tensor(tu), torch.as_tensor(tk),
                                torch.tensor(t0), DT, torch.tensor(t), torch.as_tensor(x), 10,
                                feedback)
    assert got_x.shape == (10, 14) and got_t.dim() == 0 and got_t.dtype == torch.float32
    _close(got_x, want_x)
    assert float(got_t) == pytest.approx(float(want_t), abs=1e-6)


def _without_hook(plant):
    return dataclasses.replace(plant, sim_chain=None)


@pytest.mark.parametrize("integrator", [1, 3])
def test_hook_plain_version_is_the_step_loop(integrator):
    """On CPU tensors the Kuka's chain is the loop over `make_step`, bit for
    bit — and so is the chain of a plant that ships no hook."""
    _, plant = _plants()
    rng = np.random.default_rng(7)
    x0 = torch.as_tensor(rng.normal(0, 0.3, (3, 14)).astype(np.float32))
    u = torch.as_tensor(rng.normal(0, 2.0, (3, 6, 7)).astype(np.float32))
    step = make_step(plant, integrator, DT)
    x, want = x0, []
    for k in range(6):
        x = step(x, u[:, k])
        want.append(x)
    want = torch.stack(want, dim=1)
    assert plant.sim_chain is not None
    assert torch.equal(make_sim_chain(plant, integrator, DT).open_loop(x0, u), want)
    assert torch.equal(make_sim_chain(_without_hook(plant), integrator, DT).open_loop(x0, u), want)
    # the runner: control law + step + clock, written out
    tx = torch.as_tensor(rng.normal(0, 0.3, (N, 14)).astype(np.float32))
    tu = torch.as_tensor(rng.normal(0, 1.0, (N, 7)).astype(np.float32))
    tk = torch.as_tensor(rng.normal(0, 0.1, (N, 7, 14)).astype(np.float32))
    t0, t, xc = torch.tensor(0.1), torch.tensor(0.123), x0[0]
    sim_step = make_step(plant, integrator, SIM_DT)
    xs = []
    for _ in range(4):
        uc = cuda_sim_chain.get_hardware_controls(tx, tu, tk, t0, DT, t, xc, True)
        xc = sim_step(xc, uc)
        t = t + SIM_DT
        xs.append(xc)
    for p in (plant, _without_hook(plant)):
        got_x, got_t = make_sim_chain(p, integrator, SIM_DT).runner(
            tx, tu, tk, t0, DT, torch.tensor(0.123), x0[0], 4)
        assert torch.equal(got_x, torch.stack(xs)) and torch.equal(got_t, t)


def _controller(full_rollout, hook):
    ref = ref_kuka_ee(num_time_steps=N, m_blocks=4, num_alpha=A)
    prob = kuka_ee(num_time_steps=N, m_blocks=4, num_alpha=A)
    plant = prob.plant if hook else _without_hook(prob.plant)
    cfg = dataclasses.replace(interop.solver_config(ref.cfg), pallas_riccati=True)
    return driver.MPCController(plant, prob.cost, cfg, driver.MPCConfig(full_rollout=full_rollout))


@pytest.mark.parametrize("full_rollout", [True, False], ids=["full", "blocks"])
def test_warm_start_through_the_chain_is_the_step_loop(full_rollout):
    """`_warm_start` with and without the hook, and its re-rollout written
    out as the loop it replaced: all equal bit for bit."""
    rng = np.random.default_rng(11)
    f = lambda shape, s: torch.as_tensor(rng.normal(0, s, shape).astype(np.float32))
    st = driver.MPCState(x=f((N, 14), 0.3), u=f((N, 7), 1.0), K=f((N, 7, 14), 0.1),
                         P=f((N, 14, 14), 1.0), p=f((N, 14), 1.0), d=f((N, 14), 0.01),
                         t0=torch.tensor(0.0), fails=torch.tensor(0, dtype=torch.int32))
    x_act = f((14,), 0.3)
    s = torch.tensor(5, dtype=torch.int32)
    hooked = _controller(full_rollout, True)
    got = hooked._warm_start(st, x_act, s)
    for a, b in zip(got, _controller(full_rollout, False)._warm_start(st, x_act, s)):
        assert torch.equal(a, b)
    u = driver._shift(st.u, s)
    n_roll = N if full_rollout else hooked.cfg.n_blocks_f
    step = make_step(hooked.plant, hooked.cfg.integrator, hooked.cfg.dt)
    x_cur, x_sim = x_act, [x_act]
    for k in range(n_roll - 1):
        x_cur = step(x_cur, u[k])
        x_sim.append(x_cur)
    assert torch.equal(got[0][:n_roll], torch.stack(x_sim))
    assert torch.equal(got[0][n_roll:], driver._shift(st.x, s)[n_roll:])


def test_open_loop_rollout_through_the_chain_is_the_step_loop():
    _, plant = _plants()
    prob = kuka_ee(num_time_steps=N, m_blocks=4, num_alpha=A)
    rng = np.random.default_rng(13)
    x0 = torch.as_tensor(rng.normal(0, 0.3, (N, 14)).astype(np.float32))
    u = torch.as_tensor(rng.normal(0, 2.0, (N, 7)).astype(np.float32))
    step = make_step(plant, prob.cfg.integrator, prob.cfg.dt)
    loop = lambda xs, us: cuda_sim_chain.open_loop_plain(step, xs, us)   # the loop over step
    want = open_loop_rollout(prob.cfg, loop, x0, u)
    for p in (plant, _without_hook(plant)):
        chain = make_sim_chain(p, prob.cfg.integrator, prob.cfg.dt)
        got = open_loop_rollout(prob.cfg, chain.open_loop, x0, u)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # written out: block b starts from x0[b * Nf] and applies its own controls
    nf = prob.cfg.n_blocks_f
    x = x0[nf]
    for k in range(nf, 2 * nf - 1):
        x = step(x, u[k])
        assert torch.equal(want[0][k + 1], x)


def test_chain_edge_cases_and_refusals():
    _, plant = _plants()
    chain = make_sim_chain(plant, 1, DT)
    empty = chain.open_loop(torch.zeros(14), torch.zeros(0, 7))
    assert empty.shape == (0, 14)
    kw = dict(ee_type=1, gravity=0.0, integrator=1)
    meta = lambda *shape: torch.zeros(shape, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_sim_chain.kuka_open_loop_cuda(meta(14), meta(5, 7), dt=DT, **kw)
    with pytest.raises(ValueError, match="leading dims"):
        cuda_sim_chain.kuka_open_loop_cuda(meta(2, 14), meta(3, 5, 7), dt=DT, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_sim_chain.kuka_runner_cuda(meta(N, 14), meta(N, 7), meta(N, 7, 14), meta(), DT,
                                        meta(), meta(14), 10, sim_dt=SIM_DT, **kw)
    with pytest.raises(ValueError, match="knots"):
        cuda_sim_chain.kuka_runner_cuda(meta(1, 14), meta(1, 7), meta(1, 7, 14), meta(), DT,
                                        meta(), meta(14), 10, sim_dt=SIM_DT, **kw)
    # a tensor that is neither on the CPU nor on a card never reaches the plain version
    with pytest.raises(ValueError, match="CUDA"):
        chain.open_loop(meta(14), meta(5, 7))
    assert cuda_sim_chain.kuka_open_loop_cuda.counter.launches == 0
    assert cuda_sim_chain.kuka_runner_cuda.counter.launches == 0
