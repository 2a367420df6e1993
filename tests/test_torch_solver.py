"""A live Kuka EE solve of the port (parallel_ddp_tpu_torch/solver.py) against
the reference's solve at kuka_ee(num_time_steps=16, m_blocks=2, num_alpha=4),
on the reference's CPU core (the spatial-algebra `rbd` core, as
tests/test_kuka_solver.py uses).

The port runs its main-path configuration — the RBD-Jacobian, rollout and
fused Riccati ops — whose plain versions run on CPU tensors.  The two
packages' dynamics cores differ in float32 rounding only, so the solves take
the same accept/reject and alpha decisions (iters and alpha traces equal
exactly) and J agrees within J_RTOL."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from parallel_ddp_tpu.ops.integrators import make_step as ref_make_step
from parallel_ddp_tpu.presets import ee_goal as ref_ee_goal
from parallel_ddp_tpu.presets import kuka_ee as ref_kuka_ee
from parallel_ddp_tpu.solver import make_ilqr_solver as ref_make_solver
from parallel_ddp_tpu.solver import open_loop_rollout as ref_open_loop_rollout
from parallel_ddp_tpu_torch import interop
from parallel_ddp_tpu_torch.presets import kuka_ee
from parallel_ddp_tpu_torch.solver import make_ilqr_solver

N, M, A = 16, 2, 4
MAX_ITER = 8
GOAL = (0.3, -0.3, 0.9)
GOAL_WARM = (0.35, -0.25, 0.85)
# spatial-algebra vs scalar-channel float32 dynamics over 8 iterations
J_RTOL = 2e-3


@functools.lru_cache(maxsize=None)
def _reference():
    """Cold and warm reference solves through ONE compiled program: the cold
    solve starts from the open-loop rollout with explicit zero P0/p0, so the
    warm re-solve has the same argument structure and does not recompile."""
    prob = ref_kuka_ee(num_time_steps=N, m_blocks=M, num_alpha=A)
    assert "rbd" in prob.plant.name
    cfg = dataclasses.replace(prob.cfg, max_iter=MAX_ITER)
    solver = ref_make_solver(prob.plant, prob.cost, cfg)
    step = ref_make_step(prob.plant, cfg.integrator, cfg.dt)
    x0 = jnp.zeros((N, 14), jnp.float32)
    u0 = jnp.zeros((N, 7), jnp.float32)
    x_init, d_init = jax.jit(lambda x, u: ref_open_loop_rollout(cfg, step, x, u))(x0, u0)
    zP, zp = jnp.zeros((N, 14, 14), jnp.float32), jnp.zeros((N, 14), jnp.float32)
    cold = solver(x_init, u0, ref_ee_goal(list(GOAL)), P0=zP, p0=zp, d0=d_init)
    warm = solver(cold.x, cold.u, ref_ee_goal(list(GOAL_WARM)), P0=cold.P, p0=cold.p,
                  d0=cold.d)
    return cfg, (x_init, d_init), cold, warm


def _port_solver(core="cuda", pallas=True):
    cfg_ref = _reference()[0]
    prob = kuka_ee(num_time_steps=N, m_blocks=M, num_alpha=A, core=core)
    cfg = dataclasses.replace(interop.solver_config(cfg_ref), pallas_riccati=pallas)
    assert cfg == dataclasses.replace(prob.cfg, max_iter=MAX_ITER, pallas_riccati=pallas)
    return make_ilqr_solver(prob.plant, prob.cost, cfg)


def _traces(out):
    it = int(out.iters)
    return (np.asarray(out.J_trace)[: it + 1].astype(np.float64),
            np.asarray(out.alpha_trace)[: it + 1])


def _assert_same_solve(out, ref, skip_first_alpha=False):
    assert int(out.iters) == int(ref.iters)
    oj, oa = _traces(out)
    rj, ra = _traces(ref)
    s = 1 if skip_first_alpha else 0
    np.testing.assert_array_equal(oa[s:], ra[s:])
    np.testing.assert_allclose(oj, rj, rtol=J_RTOL)
    np.testing.assert_allclose(float(out.J), float(ref.J), rtol=J_RTOL)
    assert bool(out.converged) == bool(ref.converged)


@functools.lru_cache(maxsize=None)
def _port_cold():
    solver = _port_solver()
    out = solver(torch.zeros(N, 14), torch.zeros(N, 7),
                 interop.goal(ref_ee_goal(list(GOAL))), initial_rollout=True)
    return solver, out


def test_cold_solve_matches_reference():
    """From a zero start with the port's own open-loop rollout."""
    _, _, ref, _ = _reference()
    _, out = _port_cold()
    # alpha_trace[0] marks the start (0 = initial rollout, -1 = given)
    assert int(out.alpha_trace[0]) == 0 and int(ref.alpha_trace[0]) == -1
    _assert_same_solve(out, ref, skip_first_alpha=True)
    assert np.any(np.asarray(ref.alpha_trace)[1:] >= 0)      # something accepted
    assert float(out.J) < float(out.J_trace[0])


def test_open_loop_rollout_matches_reference():
    from parallel_ddp_tpu_torch.solver import open_loop_rollout

    cfg, (x_init, d_init), _, _ = _reference()
    solver = _port_solver()
    rng = np.random.default_rng(0)
    u = rng.normal(0, 3.0, (N, 7)).astype(np.float32)
    x0 = np.zeros((N, 14), np.float32)
    x, d = open_loop_rollout(solver.cfg, solver.chain.open_loop, torch.as_tensor(x0), torch.zeros(N, 7))
    np.testing.assert_allclose(x.numpy(), np.asarray(x_init), atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_init), atol=1e-6)
    prob = ref_kuka_ee(num_time_steps=N, m_blocks=M, num_alpha=A)
    step = ref_make_step(prob.plant, cfg.integrator, cfg.dt)
    xr, dr = ref_open_loop_rollout(cfg, step, jnp.asarray(x0), jnp.asarray(u))
    x, d = open_loop_rollout(solver.cfg, solver.chain.open_loop, torch.as_tensor(x0), torch.as_tensor(u))
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(d.numpy(), np.asarray(dr), rtol=1e-5, atol=1e-5)


def test_warm_resolve_matches_reference():
    """Warm start carried across from the reference's cold solve (x, u, P, p,
    d via interop), toward a moved goal: both packages start from identical
    inputs."""
    _, _, cold, ref = _reference()
    solver = _port_solver()
    out = solver(goal=interop.goal(ref_ee_goal(list(GOAL_WARM))), initial_rollout=False,
                 **interop.warm_start(cold))
    _assert_same_solve(out, ref)


def test_hooks_change_nothing():
    """The soa core without kernel hooks and the per-step backward sweep give
    the same solve as the main-path configuration (whose ops run their plain
    versions on the CPU)."""
    _, main = _port_cold()
    out = _port_solver(core="soa", pallas=False)(
        torch.zeros(N, 14), torch.zeros(N, 7), interop.goal(ref_ee_goal(list(GOAL))),
        initial_rollout=True)
    np.testing.assert_array_equal(_traces(out)[1], _traces(main)[1])
    np.testing.assert_allclose(_traces(out)[0], _traces(main)[0], rtol=1e-5)
    torch.testing.assert_close(out.x, main.x, rtol=1e-4, atol=1e-4)


def test_iteration_budget_and_host_syncs():
    """iter_limit caps a solve of the same solver object, and the host reads
    one exit flag per rho attempt plus one per iteration but the last."""
    solver, main = _port_cold()
    out = solver(torch.zeros(N, 14), torch.zeros(N, 7),
                 interop.goal(ref_ee_goal(list(GOAL))), initial_rollout=True, iter_limit=2)
    assert out.iters == 2
    assert solver.host_syncs == 2 + 1
    np.testing.assert_array_equal(_traces(out)[1], _traces(main)[1][:3])


def test_assoc_scan_option_is_taken_and_bf16_with_it():
    """bp_assoc_scan (the exact log-depth backward pass) builds a solver,
    and so do the two bf16 options with it: the forward simulation is the
    rollout op's bfloat16 entry, the stage cost the wrapped one, the
    backward pass still the exact one."""
    prob = kuka_ee(num_time_steps=N, m_blocks=M, num_alpha=A)
    cfg = dataclasses.replace(prob.cfg, pallas_riccati=False, state_reg=False,
                              bp_assoc_scan=True)
    assert make_ilqr_solver(prob.plant, prob.cost, cfg).cfg.bp_assoc_scan
    solver = make_ilqr_solver(prob.plant, prob.cost,
                              dataclasses.replace(cfg, bf16_rollout=True, bf16_cost=True))
    assert solver.cfg.bp_assoc_scan and solver.cfg.bf16_rollout and solver.cfg.bf16_cost
    assert solver.fused_sim is not None and solver.stage is not prob.cost.stage
    out = solver(torch.zeros(N, 14), torch.zeros(N, 7), interop.goal(ref_ee_goal(list(GOAL))),
                 initial_rollout=True, iter_limit=2)
    assert out.J_trace.dtype == torch.float32 and bool(torch.isfinite(out.x).all())
    assert float(out.J) <= float(out.J_trace[0])


def test_reference_bf16_rollout_config_is_taken():
    """A reference configuration with bf16_rollout maps through
    `interop.solver_config` to a port solver that takes it and whose cold
    solve lowers J (the trace against the float32 solve:
    tests/test_torch_bf16.py)."""
    cfg_ref = _reference()[0]
    prob = kuka_ee(num_time_steps=N, m_blocks=M, num_alpha=A)
    cfg = interop.solver_config(dataclasses.replace(cfg_ref, bf16_rollout=True))
    assert cfg.bf16_rollout and not cfg.bf16_cost
    solver = make_ilqr_solver(prob.plant, prob.cost, cfg)
    assert solver.step_fwd is not solver.step_fn and solver.fused_sim is not None
    out = solver(torch.zeros(N, 14), torch.zeros(N, 7), interop.goal(ref_ee_goal(list(GOAL))),
                 initial_rollout=True)
    assert bool(torch.isfinite(out.x).all()) and float(out.J) < float(out.J_trace[0])
