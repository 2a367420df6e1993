"""The WAFR example's analytic plants, joint costs, presets and the
finite-difference step Jacobian of the port against the JAX package, on the
same seeded numpy inputs (CPU).

Tolerances, each from what differs between the two sides:
  * dynamics and steps: the same expressions in float32; the sin/cos
    implementations and the order of a few sums differ, and the quadrotor's
    Euler-rate solve is W^-1 in closed form here against JAX's LU: a few
    ulps of the largest value (DYN_RTOL, DYN_ATOL x max|ref|);
  * AD step Jacobians: the same chain rule through those expressions
    (JAC_RTOL, JAC_ATOL x max|ref|);
  * FD Jacobians: both sides compute (step(z + eps e_i) - step(z - eps e_i))
    / (2 eps) at the very same float32 points z +- eps e_i, so the two differ
    by at most max|step_port(z') - step_jax(z')| / eps over those points,
    plus the rounding of the difference and the division (2 ulps of the
    column); the bound is computed from the steps measured at those points;
  * FD against AD: truncation eps^2/6 |d3 step| (negligible at eps = 1e-4)
    plus rounding ~ ulp(|x'|) / eps = 2^-24 max|x'| / eps per step output,
    FD_ROUNDING_ULPS of them;
  * joint costs: the same products, summed in another order (COST_RTOL);
    gradients and Hessians are the same single products (bit for bit).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_ddp_tpu import presets as ref_presets
from parallel_ddp_tpu.config import CostWeights as RefWeights
from parallel_ddp_tpu.costs import joint as ref_joint
from parallel_ddp_tpu.models import cartpole as ref_cartpole
from parallel_ddp_tpu.models import pendulum as ref_pendulum
from parallel_ddp_tpu.models import quadrotor as ref_quadrotor
from parallel_ddp_tpu.models.kuka import kuka as ref_kuka
from parallel_ddp_tpu.models.kuka import kuka_params as ref_kuka_params
from parallel_ddp_tpu.ops import integrators as ref_integrators
from parallel_ddp_tpu_torch import interop, presets
from parallel_ddp_tpu_torch.config import SolverConfig, weights_of
from parallel_ddp_tpu_torch.costs import joint
from parallel_ddp_tpu_torch.models import cartpole, pendulum, quadrotor
from parallel_ddp_tpu_torch.models.kuka import kuka, kuka_params
from parallel_ddp_tpu_torch.ops import integrators

DYN_RTOL, DYN_ATOL = 1e-5, 1e-6
JAC_RTOL, JAC_ATOL = 1e-4, 1e-5
FD_ROUNDING_ULPS = 8
COST_RTOL = 1e-6
BATCH = 64
DT = 0.01
ULP = 2.0 ** -24

PLANTS = {"pendulum": (ref_pendulum, pendulum), "cartpole": (ref_cartpole, cartpole),
          "quadrotor": (ref_quadrotor, quadrotor)}


def _inputs(plant, seed, batch=BATCH):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1.0, (batch, plant.n_state)).astype(np.float32)
    u = rng.normal(0, 5.0, (batch, plant.n_ctrl)).astype(np.float32)
    return x, u


def _close(got, ref, rtol, atol_scale, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol_scale * np.abs(ref).max(),
                               err_msg=what)


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("name", PLANTS)
def test_dynamics_match_jax(name):
    ref_plant, plant = PLANTS[name][0](), PLANTS[name][1]()
    assert (plant.name, plant.n_pos, plant.n_ctrl) == (ref_plant.name, ref_plant.n_pos,
                                                       ref_plant.n_ctrl)
    for field in ("rho_init_default", "max_defect_default", "alpha_base_default",
                  "num_alpha_default"):
        assert getattr(plant, field) == getattr(ref_plant, field), field
    x, u = _inputs(plant, 0)
    ref = jax.jit(jax.vmap(ref_plant.dynamics))(x, u)
    got = plant.dynamics(_t(x), _t(u))
    assert got.shape == (BATCH, plant.n_pos) and got.dtype == torch.float32
    _close(got, ref, DYN_RTOL, DYN_ATOL, f"{name} qdd")
    # any leading dims: one sample and a (4, 16) grid give the same values
    torch.testing.assert_close(plant.dynamics(_t(x[0]), _t(u[0])), got[0], rtol=0, atol=0)
    grid = plant.dynamics(_t(x).reshape(4, 16, -1), _t(u).reshape(4, 16, -1))
    torch.testing.assert_close(grid.reshape(BATCH, -1), got, rtol=0, atol=0)


@pytest.mark.parametrize("integrator", [1, 2, 3])
@pytest.mark.parametrize("name", PLANTS)
def test_step_and_jacobian_match_jax(name, integrator):
    ref_plant, plant = PLANTS[name][0](), PLANTS[name][1]()
    x, u = _inputs(plant, integrator)
    ref_step = jax.jit(jax.vmap(ref_integrators.make_step(ref_plant, integrator, DT)))
    ref_jac = jax.jit(jax.vmap(ref_integrators.make_step_jacobian(ref_plant, integrator, DT)))
    step = integrators.make_step(plant, integrator, DT)
    jac = integrators.make_step_jacobian(plant, integrator, DT)
    _close(step(_t(x), _t(u)), ref_step(x, u), DYN_RTOL, DYN_ATOL, f"{name} step")
    ab = torch.func.vmap(jac)(_t(x), _t(u))
    # forward mode must stay float32 (a 0-d channel times a Python number
    # would give float64 tangents)
    assert ab.dtype == torch.float32
    _close(ab, ref_jac(x, u), JAC_RTOL, JAC_ATOL, f"{name} AB")


def _fd_cases():
    return [(name, integ) for name in PLANTS for integ in (1, 3)] + [("kuka", 1), ("kuka", 3)]


def _fd_plants(name):
    if name == "kuka":
        # full gravity; the port's kernel core (its plain versions on the CPU)
        # against the JAX package's CPU core
        return ref_kuka(ref_kuka_params()), kuka(kuka_params(core="cuda"))
    return PLANTS[name][0](), PLANTS[name][1]()


@pytest.mark.parametrize("name,integrator", _fd_cases())
def test_fd_jacobian_matches_jax_fd_and_ad(name, integrator):
    ref_plant, plant = _fd_plants(name)
    eps = SolverConfig().fd_eps
    # states away from the quadrotor's gimbal singularity (cos(pitch) = 0),
    # where the truncation error of the differences would dominate
    rng = np.random.default_rng(10 + integrator)
    x = rng.normal(0, 0.3, (16, plant.n_state)).astype(np.float32)
    u = rng.normal(0, 2.0, (16, plant.n_ctrl)).astype(np.float32)
    if name == "kuka":
        rng = np.random.default_rng(integrator)
        x = rng.normal(0, 0.5, (16, 14)).astype(np.float32)
        u = rng.normal(0, 20.0, (16, 7)).astype(np.float32)
    fd = integrators.make_step_jacobian_fd(plant, integrator, DT, eps)
    assert fd._is_batched
    got = fd(_t(x), _t(u))
    n, m = plant.n_state, plant.n_ctrl
    assert got.shape == (16, n, n + m) and got.dtype == torch.float32
    ref = jax.jit(jax.vmap(ref_integrators.make_step_jacobian_fd(ref_plant, integrator, DT,
                                                                 eps)))(x, u)
    # the perturbed points, as both sides form them, and each side's steps there
    z = np.concatenate([x, u], -1)
    delta = (np.eye(n + m) * np.float32(eps)).astype(np.float32)
    pts = np.concatenate([z[None] + delta[:, None], z[None] - delta[:, None]])
    ref_step = jax.jit(jax.vmap(ref_integrators.make_step(ref_plant, integrator, DT)))
    port_step = integrators.make_step(plant, integrator, DT)
    flat = pts.reshape(-1, n + m)
    x_ref = np.asarray(ref_step(flat[:, :n], flat[:, n:]), np.float64)
    x_port = port_step(_t(flat[:, :n]), _t(flat[:, n:])).double().numpy()
    bound = np.abs(x_port - x_ref).max() / eps + 2 * ULP * np.abs(np.asarray(ref)).max()
    gap = np.abs(got.double().numpy() - np.asarray(ref, np.float64)).max()
    assert gap <= bound, (gap, bound)
    # against the AD Jacobian: rounding of the two steps over 2 eps
    if name == "kuka":
        ad = plant.batched_step_jac(integrator, DT)(_t(x), _t(u))
    else:
        ad = torch.func.vmap(integrators.make_step_jacobian(plant, integrator, DT))(_t(x), _t(u))
    fd_tol = FD_ROUNDING_ULPS * ULP * np.abs(x_port).max() / eps
    np.testing.assert_allclose(got.numpy(), ad.numpy(), rtol=0, atol=fd_tol)


def test_fd_jacobian_steps_once_for_the_whole_horizon():
    """The 2 (n + m) perturbed copies of every sample go through one step
    call: one dynamics evaluation per integrator stage, whatever the batch."""
    calls = []
    base = kuka(kuka_params(core="cuda"))

    def counted(x, u):
        calls.append(x.shape[:-1])
        return base.dynamics(x, u)

    plant = dataclasses.replace(base, dynamics=counted)
    for integrator, stages in ((1, 1), (2, 2), (3, 3)):
        calls.clear()
        integrators.make_step_jacobian_fd(plant, integrator, DT)(torch.zeros(63, 14),
                                                                torch.zeros(63, 7))
        assert calls == [(42, 63)] * stages


def _cost_case(seed, n, m, N):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1.0, (BATCH, n)).astype(np.float32)
    u = rng.normal(0, 2.0, (BATCH, m)).astype(np.float32)
    goal = rng.normal(0, 1.0, n).astype(np.float32)
    k = rng.integers(0, N, BATCH)
    k[:8] = N - 1                      # terminal knots among them
    return x, u, goal, k


COSTS = {
    "pendulum": lambda N: (ref_joint.pendulum_cost(N), joint.pendulum_cost(N), 2, 1),
    "cartpole": lambda N: (ref_joint.cartpole_cost(N), joint.cartpole_cost(N), 4, 1),
    "quadrotor": lambda N: (ref_joint.quadrotor_cost(N), joint.quadrotor_cost(N), 12, 4),
    "kuka_joint": lambda N: (ref_joint.joint_cost("kuka_joint", N, 7, 7),
                             joint.joint_cost("kuka_joint", N, 7, 7), 14, 7),
}


@pytest.mark.parametrize("weights", ["default", "tuned"])
@pytest.mark.parametrize("name", COSTS)
def test_joint_costs_match_jax(name, weights):
    N = 16
    ref_cost, cost, n, m = COSTS[name](N)
    assert cost.name == ref_cost.name
    x, u, goal, k = _cost_case(len(name), n, m, N)
    w = RefWeights() if weights == "default" else RefWeights(q1=0.3, q2=0.02, r=0.005,
                                                            qf1=50.0, qf2=7.0)
    ref_stage = jax.vmap(lambda xk, uk, kk: ref_cost.stage(xk, uk, kk, jnp.asarray(goal), w))
    ref_quad = jax.vmap(lambda xk, uk, kk: ref_cost.quad(xk, uk, kk, jnp.asarray(goal), w))
    pw = weights_of(interop.cost_weights(w), torch.zeros(()))
    got = cost.stage(_t(x), _t(u), _t(k), _t(goal), pw)
    _close(got, ref_stage(x, u, k), COST_RTOL, COST_RTOL, f"{name} stage")
    h, g = cost.quad(_t(x), _t(u), _t(k), _t(goal), pw)
    rh, rg = ref_quad(x, u, k)
    np.testing.assert_array_equal(g.numpy(), np.asarray(rg))
    np.testing.assert_array_equal(h.numpy(), np.asarray(rh))
    # the terminal knot has no control cost and the terminal state weights
    assert bool((g[:8, n:] == 0).all())
    # one knot at a time and the time axis (k broadcast against x's leading
    # dims, as the solver calls it) give the same values
    one = cost.stage(_t(x[0]), _t(u[0]), _t(k[0]), _t(goal), pw)
    torch.testing.assert_close(one, got[0], rtol=0, atol=0)
    ks = torch.arange(N)
    xs = _t(x[:N])[None].expand(3, N, n)
    us = _t(u[:N])[None].expand(3, N, m)
    torch.testing.assert_close(cost.stage(xs, us, ks, _t(goal), pw)[1],
                               cost.stage(_t(x[:N]), _t(u[:N]), ks, _t(goal), pw),
                               rtol=0, atol=0)


def test_joint_cost_weights_are_data():
    """kuka_joint's weights come from the (21,) weights tensor: another value
    is another cost, from the same functions."""
    cost = joint.joint_cost("kuka_joint", 8, 7, 7)
    x, u = torch.ones(8, 14), torch.ones(8, 7)
    ks, goal = torch.arange(8), torch.zeros(14)
    a = cost.stage(x, u, ks, goal, weights_of(None, x))
    b = cost.stage(x, u, ks, goal, weights_of(interop.cost_weights(RefWeights(q1=1.0)), x))
    assert bool((b[:-1] > a[:-1]).all()) and torch.equal(a[-1], b[-1])


PRESETS = {
    "pendulum_swingup": ({}, dict(num_time_steps=32, total_time=1.5, m_blocks=2, num_alpha=8)),
    "cartpole_swingup": ({}, dict(num_time_steps=64, total_time=2.0, m_blocks=2, num_alpha=16)),
    "quadrotor_task": ({}, dict(num_time_steps=64, total_time=2.0, m_blocks=2, num_alpha=16)),
    "kuka_joint": ({}, dict(num_time_steps=32, m_blocks=2, num_alpha=8, integrator=3,
                            mpc_mode=True)),
}


@pytest.mark.parametrize("kwargs", ["defaults", "wafr_example"])
@pytest.mark.parametrize("name", PRESETS)
def test_presets_match_jax(name, kwargs):
    kw = PRESETS[name][0 if kwargs == "defaults" else 1]
    ref = getattr(ref_presets, name)(**kw)
    port = getattr(presets, name)(**kw)
    assert interop.solver_config(ref.cfg) == port.cfg
    assert port.cfg.pallas_riccati is False
    mapped = interop.plant(ref.plant)
    assert (mapped.n_pos, mapped.n_ctrl) == (port.plant.n_pos, port.plant.n_ctrl)
    assert port.cost.name == ref.cost.name
    if name == "kuka_joint":
        assert port.plant.name.endswith("_cuda")
        assert ("_g0_" in port.plant.name) == bool(kw.get("mpc_mode"))
    else:
        assert mapped == port.plant and port.plant.name == ref.plant.name


def test_interop_plant():
    for ref_fn, port_fn in PLANTS.values():
        assert interop.plant(ref_fn()) == port_fn()
    full = interop.plant(ref_kuka(ref_kuka_params(core="pallas")))
    assert full.name == "kuka_ee1_g9.81_cuda" and full.batched_step_jac is not None
    comp = interop.plant(ref_kuka(ref_kuka_params(mpc_mode=True)))
    assert comp.name == "kuka_ee1_g0_soa" and comp.batched_step_jac is None

    class Other:
        name = "double_pendulum"

    with pytest.raises(ValueError, match="no counterpart"):
        interop.plant(Other())


def test_interop_goal_takes_bare_arrays():
    one = jnp.asarray([np.pi, 0.0])
    g = interop.goal(one)
    assert isinstance(g, torch.Tensor) and g.dtype == torch.float32
    np.testing.assert_array_equal(g.numpy(), np.asarray(one))
    batch = jnp.stack([one, one + 1.0])
    assert interop.goal(batch).shape == (2, 2)
    assert torch.equal(interop.goal([one, one + 1.0]), interop.goal(batch))
    d = interop.goal({"ee_goal": jnp.zeros(6), "x_target": jnp.ones(14)})
    assert set(d) == {"ee_goal", "x_target"} and d["x_target"].shape == (14,)


def test_solver_takes_finite_differences_and_refuses_the_rest():
    from parallel_ddp_tpu_torch.solver import make_ilqr_solver

    prob = presets.pendulum_swingup(num_time_steps=16, total_time=1.0, m_blocks=2, num_alpha=4)
    solver = make_ilqr_solver(prob.plant, prob.cost,
                              dataclasses.replace(prob.cfg, use_finite_diff=True))
    assert getattr(solver.step_jac, "_is_batched", False)
    # the bfloat16 options are taken (they raised before the port had them,
    # whence the test's name): the line search's step and the stage cost are
    # the wrapped ones
    x, u = torch.tensor([[0.3, -0.2]]), torch.tensor([[0.7]])
    roll = make_ilqr_solver(prob.plant, prob.cost, dataclasses.replace(prob.cfg, bf16_rollout=True))
    assert roll.step_fwd is not roll.step_fn and roll.stage is prob.cost.stage
    got = roll.step_fwd(x, u)
    assert got.dtype == torch.float32 and torch.equal(
        got, roll.step_fn(x.bfloat16(), u.bfloat16()).float())
    cost = make_ilqr_solver(prob.plant, prob.cost, dataclasses.replace(prob.cfg, bf16_cost=True))
    assert cost.step_fwd is cost.step_fn and cost.stage is not prob.cost.stage
