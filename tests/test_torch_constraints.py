"""The port's augmented-Lagrangian box constraints
(parallel_ddp_tpu_torch/constraints.py) against the JAX package's
(parallel_ddp_tpu/constraints.py) on the same inputs, seeded with numpy, on
the CPU.

Tolerances:
  * residuals, clip_u and the PHR penalty run the same float32 expressions
    on both sides: equal bit for bit;
  * al_cost's stage, gradient and Hessian: rtol 1e-5 of each quantity's
    scale (the base costs' own parity bound, tests/test_torch_costs.py);
  * solve_al on the pendulum (the same expressions on both sides): the same
    outer count and the same alphas in every inner solve, J within
    J_RTOL_EXACT, the violations within VIOL_ATOL;
  * the constrained MPC against the JAX controller: MPC_J_RTOL and
    MPC_X_ATOL (tests/test_torch_plant_solves.py's bounds, the port's
    Riccati op against the JAX scan);
  * the Kuka against the JAX package's spatial-algebra core: J within
    J_RTOL_CORES (tests/test_torch_solver.py's), the alphas equal;
  * a batched constrained solve against its single solves: bit for bit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallel_ddp_tpu.solver as ref_solver_module
from parallel_ddp_tpu import constraints as ref
from parallel_ddp_tpu import presets as ref_presets
from parallel_ddp_tpu.config import CostWeights as RefWeights
from parallel_ddp_tpu.config import SolverConfig as RefSolverConfig
from parallel_ddp_tpu.costs.ee import ee_cost as ref_ee_cost
from parallel_ddp_tpu.costs.joint import pendulum_cost as ref_pendulum_cost
from parallel_ddp_tpu.models import pendulum as ref_pendulum
from parallel_ddp_tpu.models.kuka.soa import KukaSoA as RefSoA
from parallel_ddp_tpu.mpc.driver import MPCConfig as RefMPCConfig
from parallel_ddp_tpu.ops.integrators import make_step as ref_make_step
from parallel_ddp_tpu_torch import constraints, graphs, interop, presets
from parallel_ddp_tpu_torch.costs import ee
from parallel_ddp_tpu_torch.costs.joint import pendulum_cost
from parallel_ddp_tpu_torch.models.kuka.soa import KukaSoA
from parallel_ddp_tpu_torch.mpc.driver import MPCConfig
from parallel_ddp_tpu_torch.parallel.sharding import make_batched_solver
from parallel_ddp_tpu_torch.solver import make_ilqr_solver

J_RTOL_EXACT = 1e-5
J_RTOL_CORES = 2e-3
VIOL_ATOL = 1e-4
MPC_J_RTOL, MPC_X_ATOL = 1e-4, 1e-4
GOAL = [np.pi, 0.0]

# each bound group alone and all four (pendulum sizes, n = 2, m = 1)
BOUNDS = {
    "u_min": dict(u_min=[-1.0]),
    "u_max": dict(u_max=[1.0]),
    "x_min": dict(x_min=[-0.5, -1.0]),
    "x_max": dict(x_max=[0.5, 1.0]),
    "all": dict(u_min=[-1.0], u_max=[1.0], x_min=[-0.5, -1.0], x_max=[0.5, 1.0]),
}


def _pair(**bounds):
    """The JAX package's BoxConstraints and the port's (through interop)."""
    con_r = ref.BoxConstraints(**bounds)
    return con_r, interop.box_constraints(con_r)


def _f32(rng, shape, scale):
    return rng.normal(0, scale, shape).astype(np.float32)


def _exact(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _ref_per_knot(fn, *arrays):
    """fn(*knot values, k) of the reference vmapped over the knots."""
    return jax.vmap(fn)(*arrays, jnp.arange(arrays[0].shape[0]))


@pytest.mark.parametrize("name", sorted(BOUNDS))
def test_box_pieces_match_jax(name):
    """residuals (with the terminal mask), clip_u, jac_blocks and n_c."""
    con_r, con = _pair(n_state=2, n_ctrl=1, **BOUNDS[name])
    rng = np.random.default_rng(len(name))
    N = 6
    x, u = _f32(rng, (N, 2), 1.0), _f32(rng, (N, 1), 2.0)
    nf = N - 1
    want = _ref_per_knot(lambda xk, uk, k: con_r.residuals(xk, uk, k == nf), x, u)
    ks = torch.arange(N)
    got = con.residuals(torch.as_tensor(x), torch.as_tensor(u), ks == nf)
    _exact(got, want)
    if con.u_min is not None or con.u_max is not None:
        assert np.all(np.asarray(got)[-1, :con.n_ctrl] == 0.0)       # the terminal mask
    # a Python bool, and leading dims of x and u that broadcast
    _exact(con.residuals(torch.as_tensor(x[0]), torch.as_tensor(u[0]), True),
           con_r.residuals(x[0], u[0], True))
    both = con.residuals(torch.as_tensor(x)[None].expand(3, N, 2), torch.as_tensor(u), ks == nf)
    assert both.shape == (3, N, con.n_c)
    _exact(both[2], want)
    _exact(con.clip_u(torch.as_tensor(u)), con_r.clip_u(jnp.asarray(u)))
    assert con.jac_blocks() == con_r.jac_blocks()
    assert con.n_c == con_r.n_c


def test_phi_matches_jax():
    """The PHR penalty on active and inactive rows, at mu 10 and 50."""
    rng = np.random.default_rng(3)
    c = _f32(rng, (64,), 1.0)
    lam = np.abs(_f32(rng, (64,), 2.0)) * (rng.random(64) < 0.6)
    for mu in (10.0, 50.0):
        mu32 = np.float32(mu)
        want = ref._phi(jnp.asarray(c), jnp.asarray(lam), jnp.asarray(mu32))
        got = constraints._phi(torch.as_tensor(c), torch.as_tensor(lam), torch.tensor(mu32))
        _exact(got, want)
        assert 0 < int(np.sum(np.asarray(lam) + mu * c > 0)) < 64       # both branches


def test_no_bounds_raises():
    with pytest.raises(ValueError):
        constraints.BoxConstraints(n_state=2, n_ctrl=1).n_c


def _al_case(kind):
    """(ref base cost, port base cost, n, m, N, x, u, ref goal, bounds)."""
    rng = np.random.default_rng(11 if kind == "pendulum" else 12)
    if kind == "pendulum":
        N, n, m = 8, 2, 1
        base_r, base = ref_pendulum_cost(N), pendulum_cost(N)
        goal = jnp.asarray(GOAL, jnp.float32)
        bounds = BOUNDS["all"]
        x, u = _f32(rng, (N, n), 1.0), _f32(rng, (N, m), 2.0)
    else:
        N, n, m = 8, 14, 7
        base_r = ref_ee_cost(RefSoA(1, 0.0).ee_pose, 7, 7, N)
        soa = KukaSoA(1, 0.0)
        base = ee.ee_cost(soa.ee_pose, soa.ee_pose_jacobian, 7, 7, N)
        goal = {"ee_goal": jnp.asarray(_f32(rng, (6,), 0.3)),
                "x_target": jnp.asarray(_f32(rng, (14,), 0.2))}
        bounds = dict(u_min=[-40.0] * 7, u_max=[40.0] * 7, x_min=[-1.5] * 14,
                      x_max=[1.5] * 14)
        x, u = _f32(rng, (N, n), 1.0), _f32(rng, (N, m), 40.0)
    return base_r, base, n, m, N, x, u, goal, bounds


@pytest.mark.parametrize("mu", [10.0, 50.0])
@pytest.mark.parametrize("kind", ["pendulum", "kuka_ee"])
def test_al_cost_matches_jax(kind, mu):
    """Stage cost, gradient and (exact) Hessian of the AL cost over the time
    axis against the JAX package's per knot, with lam mixing active and
    inactive rows."""
    base_r, base, n, m, N, x, u, goal, bounds = _al_case(kind)
    con_r, con = _pair(n_state=n, n_ctrl=m, **bounds)
    rng = np.random.default_rng(int(mu))
    lam = np.abs(_f32(rng, (N, con.n_c), 5.0)) * (rng.random((N, con.n_c)) < 0.5)
    g_r = {"base": goal, "lam": jnp.asarray(lam), "mu": jnp.asarray(mu, jnp.float32)}
    cost_r = ref.al_cost(base_r, con_r, N - 1)
    w_r = RefWeights()
    r_stage = _ref_per_knot(lambda xk, uk, k: cost_r.stage(xk, uk, k, g_r, w_r), x, u)
    r_H, r_g = _ref_per_knot(lambda xk, uk, k: cost_r.quad(xk, uk, k, g_r, w_r), x, u)

    cost = constraints.al_cost(base, con, N - 1)
    assert cost.name == cost_r.name
    g = interop.goal(g_r)
    ks = torch.arange(N)
    stage = cost.stage(torch.as_tensor(x), torch.as_tensor(u), ks, g, None)
    H, grad = cost.quad(torch.as_tensor(x), torch.as_tensor(u), ks, g, None)
    c = np.asarray(con_r.residuals(x[0], u[0], False))
    active = lam[0] + mu * c > 0
    assert active.any() and not active.all()
    for got, want in ((stage, r_stage), (grad, r_g), (H, r_H)):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * max(np.abs(want).max(), 1.0))


# solve_al on the pendulum at N = 32 (2 blocks, 8 alphas) under |u| <= 3:
# the unconstrained swing-up needs more, so the outer loop has work to do
SOLVE_KW = dict(num_time_steps=32, total_time=1.0, m_blocks=2, num_alpha=8)


def _recording(make, outs):
    """A solver factory whose solvers append every output to outs."""
    def made(*args, **kw):
        solver = make(*args, **kw)

        def call(*a, **k):
            outs.append(solver(*a, **k))
            return outs[-1]

        return call

    return made


@functools.lru_cache(maxsize=None)
def _reference_solve_al():
    prob = ref_presets.pendulum_swingup(**SOLVE_KW)
    con_r = ref.BoxConstraints(n_state=2, n_ctrl=1, u_min=[-3.0], u_max=[3.0])
    outs = []
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_solver_module, "make_ilqr_solver",
               _recording(ref_solver_module.make_ilqr_solver, outs))
    try:
        out, info = ref.solve_al(prob.plant, prob.cost, prob.cfg, jnp.zeros((32, 2)),
                                 jnp.zeros((32, 1)), jnp.asarray(GOAL), con_r)
    finally:
        mp.undo()
    return con_r, jax.device_get(outs), jax.device_get(out), jax.device_get(info)


def _traces(out):
    it = int(out.iters)
    return (np.asarray(out.J_trace)[: it + 1].astype(np.float64),
            np.asarray(out.alpha_trace)[: it + 1])


def test_solve_al_matches_jax(monkeypatch):
    """The outer loop and every inner solve against the JAX package's."""
    con_r, ref_outs, ref_out, ref_info = _reference_solve_al()
    prob = presets.pendulum_swingup(**SOLVE_KW)
    outs = []
    monkeypatch.setattr(constraints, "make_ilqr_solver",
                        _recording(constraints.make_ilqr_solver, outs))
    out, info = constraints.solve_al(prob.plant, prob.cost, prob.cfg, torch.zeros(32, 2),
                                     torch.zeros(32, 1), torch.tensor(GOAL),
                                     interop.box_constraints(con_r))
    assert info["outer_iters"] == ref_info["outer_iters"] == len(outs) == len(ref_outs) >= 3
    for o, r in zip(outs, ref_outs):
        (oj, oa), (rj, ra) = _traces(o), _traces(r)
        np.testing.assert_array_equal(oa, ra)
        np.testing.assert_allclose(oj, rj, rtol=J_RTOL_EXACT)
    np.testing.assert_allclose(info["violations"], ref_info["violations"], rtol=0,
                               atol=VIOL_ATOL)
    assert info["violations"][-1] < constraints.ALConfig().tol_violation
    assert info["mu"] == ref_info["mu"]
    np.testing.assert_allclose(info["base_J"], ref_info["base_J"], rtol=J_RTOL_EXACT)
    np.testing.assert_allclose(info["lam"].numpy(), np.asarray(ref_info["lam"]), rtol=1e-4,
                               atol=1e-4 * float(np.abs(ref_info["lam"]).max()))
    np.testing.assert_allclose(float(out.J), float(ref_out.J), rtol=J_RTOL_EXACT)


def _problem128():
    return presets.pendulum_swingup(num_time_steps=128, total_time=4.0, m_blocks=4,
                                    num_alpha=16)


def test_control_bounds_enforced():
    """tests/test_constraints.py::test_control_bounds_enforced's bars on the
    port alone, at its N = 128."""
    prob = _problem128()
    x0, u0, goal = torch.zeros(128, 2), torch.zeros(128, 1), torch.tensor(GOAL)
    out_u = make_ilqr_solver(prob.plant, prob.cost, prob.cfg)(x0, u0, goal,
                                                              initial_rollout=True)
    assert float(out_u.u.abs().max()) > 8.0
    con = constraints.BoxConstraints(n_state=2, n_ctrl=1, u_min=[-6.0], u_max=[6.0])
    out_c, info = constraints.solve_al(prob.plant, prob.cost, prob.cfg, x0, u0, goal, con)
    assert float(out_c.u.abs().max()) <= 6.0 + 1e-3
    np.testing.assert_allclose(out_c.x[-1].numpy(), GOAL, atol=0.05)
    assert info["violations"][-1] < 1e-3
    assert info["base_J"] > float(out_u.J) - 1e-3


def test_state_bounds_enforced():
    """tests/test_constraints.py::test_state_bounds_enforced's bars on the
    port alone, at its N = 128."""
    prob = _problem128()
    con = constraints.BoxConstraints(n_state=2, n_ctrl=1, x_min=[-100.0, -2.2],
                                     x_max=[100.0, 2.2])
    out, info = constraints.solve_al(prob.plant, prob.cost, prob.cfg, torch.zeros(128, 2),
                                     torch.zeros(128, 1), torch.tensor(GOAL), con)
    assert float(out.x[:, 1].abs().max()) <= 2.2 + 1e-3
    np.testing.assert_allclose(out.x[-1].numpy(), GOAL, atol=0.05)
    assert info["outer_iters"] <= constraints.ALConfig().max_outer
    v = info["violations"]
    assert v[-1] <= v[0]


# tests/test_constraints.py::test_constrained_mpc_closed_loop's controller
MPC_CFG = dict(num_time_steps=48, total_time=2.0, m_blocks_b=2, m_blocks_f=2, num_alpha=8,
               alpha_base=0.75, integrator=3, rho_init=10.0)
MPC_PERIODS = 5


def _al_controllers(max_shift=None):
    con_r = ref.BoxConstraints(n_state=2, n_ctrl=1, u_min=[-6.0], u_max=[6.0])
    cfg_r = RefSolverConfig(**MPC_CFG)
    ctrl_r = ref.ALMPCController(ref_pendulum(), ref_pendulum_cost(48), cfg_r,
                                 RefMPCConfig(max_iters_per_solve=6, max_shift_steps=max_shift),
                                 con_r, mu=50.0)
    cfg = dataclasses.replace(interop.solver_config(cfg_r), pallas_riccati=True)
    prob = presets.pendulum_swingup(num_time_steps=48, total_time=2.0, m_blocks=2, num_alpha=8)
    assert dataclasses.replace(prob.cfg, pallas_riccati=True) == cfg
    ctrl = constraints.ALMPCController(prob.plant, prob.cost, cfg,
                                       MPCConfig(max_iters_per_solve=6, max_shift_steps=max_shift),
                                       interop.box_constraints(con_r), mu=50.0)
    return ctrl_r, ctrl


@functools.lru_cache(maxsize=None)
def _reference_al_mpc():
    """The JAX controller's first MPC_PERIODS periods of the closed loop of
    tests/test_constraints.py (two 100 Hz RK3 plant steps of the clipped
    command a period): the states it measured, and its outputs."""
    ctrl_r, _ = _al_controllers()
    goal = jnp.asarray(GOAL)
    x = np.zeros(2, np.float32)
    st, lam = ctrl_r.init_state(x, t0=0.0, goal=goal)
    sim = ref_make_step(ref_pendulum(), 3, 0.01)
    start = jax.device_get((st, lam))
    t, xs, periods = 0.0, [], []
    for _ in range(MPC_PERIODS):
        xs.append((x.copy(), t))
        st, lam, info = ctrl_r.step(st, lam, x, t, goal)
        periods.append(jax.device_get((st, lam, info)))
        for _ in range(2):
            x = np.asarray(sim(jnp.asarray(x), ctrl_r.con.clip_u(st.u[0])))
            t += 0.01
    return start, xs, periods


def test_al_mpc_matches_jax():
    """init_state and MPC_PERIODS periods of ALMPCController against the
    JAX controller's.  The cold start is a 50-iteration swing-up whose last
    accepted step is a near tie (its candidates differ by ~4e-7 of J): the
    two packages take the same alphas up to it and then different ones
    (measured), which moves the state by ~2e-3; so the cold starts are held
    by their AL cost, and the periods run from the JAX controller's state
    (carried across by interop), on the same measured states."""
    (st_r, lam_r), xs, periods = _reference_al_mpc()
    _, ctrl = _al_controllers()
    goal = torch.tensor(GOAL)
    st, lam = ctrl.init_state(torch.zeros(2), t0=0.0, goal=goal)
    _exact(lam, lam_r)
    ks = torch.arange(48)
    cost = lambda s: float(ctrl.ctrl.cost.stage(s.x, s.u, ks, ctrl.wrap_goal(goal, lam),
                                                None).sum())
    np.testing.assert_allclose(cost(st), cost(interop.mpc_state(st_r)), rtol=J_RTOL_EXACT)
    st, lam = interop.mpc_state(st_r), interop.tensor(lam_r)
    for (x, t), (ref_st, ref_lam, ref_info) in zip(xs, periods):
        st, lam, info = ctrl.step(st, lam, torch.as_tensor(x), t, goal)
        assert bool(info.accepted) == bool(ref_info.accepted)
        assert int(info.iters) == int(ref_info.iters)
        assert int(info.shift_steps) == int(ref_info.shift_steps)
        np.testing.assert_allclose(float(info.J), float(ref_info.J), rtol=MPC_J_RTOL)
        np.testing.assert_allclose(st.x.numpy(), ref_st.x, rtol=0, atol=MPC_X_ATOL)
        np.testing.assert_allclose(st.u.numpy(), ref_st.u, rtol=0, atol=10 * MPC_X_ATOL)
        np.testing.assert_allclose(lam.numpy(), ref_lam, rtol=MPC_J_RTOL,
                                   atol=MPC_J_RTOL * max(float(np.abs(ref_lam).max()), 1.0))
    assert float(lam.abs().max()) > 0                      # the multipliers did work
    assert ctrl.host_syncs > 0                             # the CPU's host loop


@pytest.mark.parametrize("max_shift", [None, 2])
def test_shift_lam_matches_jax(max_shift):
    """The multipliers' shift is the driver's, with and without
    max_shift_steps, at clocks that move 0, 1, 3 and past N knots."""
    ctrl_r, ctrl = _al_controllers(max_shift)
    rng = np.random.default_rng(5)
    lam = _f32(rng, (48, 2), 1.0)
    dt = ctrl.cfg.dt
    for t0, t_now in ((0.5, 0.5), (0.5, 0.5 + 1.2 * dt), (0.25, 0.25 + 3.5 * dt),
                      (0.0, 60 * dt), (1.0, 0.9)):
        want = ctrl_r._shift_lam(jnp.asarray(lam), jnp.float32(t0), jnp.float32(t_now))
        got = ctrl.shift_lam(torch.as_tensor(lam), torch.tensor(t0, dtype=torch.float32),
                             torch.tensor(t_now, dtype=torch.float32))
        _exact(got, want)


def test_batched_constrained_solve_equals_single_solves():
    """make_batched_solver on the AL cost with a lam (B, N, n_c) and a mu
    (B,) per scenario: each scenario bit for bit its single solve."""
    B, N = 4, 16
    prob = presets.pendulum_swingup(num_time_steps=N, total_time=1.0, m_blocks=2, num_alpha=4)
    cfg = dataclasses.replace(prob.cfg, max_iter=8)
    con = constraints.BoxConstraints(n_state=2, n_ctrl=1, u_min=[-4.0], u_max=[4.0])
    cost = constraints.al_cost(prob.cost, con, N - 1)
    rng = np.random.default_rng(9)
    lam = torch.as_tensor(np.abs(_f32(rng, (B, N, con.n_c), 3.0)))
    lam[0] = 0.0
    mu = torch.tensor([10.0, 50.0, 10.0, 250.0])
    goals = {"base": torch.tensor(GOAL).expand(B, 2).contiguous(), "lam": lam, "mu": mu}
    out = make_batched_solver(prob.plant, cost, cfg)(torch.zeros(B, N, 2), torch.zeros(B, N, 1),
                                                      goals)
    solver = make_ilqr_solver(prob.plant, cost, cfg)
    Js = set()
    for b in range(B):
        one = solver(torch.zeros(N, 2), torch.zeros(N, 1),
                     {"base": torch.tensor(GOAL), "lam": lam[b], "mu": mu[b]},
                     initial_rollout=True)
        for got, want in zip(out, one):
            assert torch.equal(got[b], want), b
        Js.add(float(one.J))
    assert len(Js) == B                                   # the multipliers took effect


def test_new_lam_and_mu_make_no_capture():
    """On the graph route (`graphs.emulate()`): new lam and mu values are
    data, not a new capture, and they take effect; a constrained solve's
    outer loop runs on one solver with two captures (cold, warm) however
    many outer iterations and calls it takes; an AL MPC period is one
    capture."""
    N = 16
    prob = presets.pendulum_swingup(num_time_steps=N, total_time=1.0, m_blocks=2, num_alpha=4)
    cfg = dataclasses.replace(prob.cfg, max_iter=4)
    con = constraints.BoxConstraints(n_state=2, n_ctrl=1, u_min=[-3.0], u_max=[3.0])
    solver = make_ilqr_solver(prob.plant, constraints.al_cost(prob.cost, con, N - 1), cfg)
    x0, u0, goal = torch.zeros(N, 2), torch.zeros(N, 1), torch.tensor(GOAL)
    lam0 = torch.zeros(N, con.n_c)
    with graphs.emulate():
        a = solver(x0, u0, {"base": goal, "lam": lam0, "mu": torch.tensor(10.0)},
                   initial_rollout=True)
        n0 = len(solver.graphs)
        b = solver(x0, u0, {"base": goal, "lam": lam0 + 0.5, "mu": torch.tensor(50.0)},
                   initial_rollout=True)
        assert len(solver.graphs) == n0 == 1
        assert float(a.J) != float(b.J)

        al = constraints.make_al_solver(prob.plant, prob.cost, cfg, con,
                                        constraints.ALConfig(max_outer=4))
        _, info = al(x0, u0, goal)
        _, again = al(x0, u0, goal + 0.1)
        assert info["outer_iters"] >= 3 and len(al.solver.graphs) == 2
        assert again["base_J"] != info["base_J"]

        ctrl = constraints.ALMPCController(prob.plant, prob.cost, cfg,
                                           MPCConfig(max_iters_per_solve=2), con)
        st, lam = ctrl.init_state(torch.zeros(2), goal=goal, warmup_iters=4)
        _, lam1, info1 = ctrl.step(st, lam, torch.zeros(2), 0.05, goal)
        _, _, info2 = ctrl.step(st, lam1 + 1.0, torch.zeros(2), 0.05, goal)
        assert len(ctrl.graphs) == 1 and ctrl.host_syncs == 0
        assert float(info1.J) != float(info2.J)


# the Kuka under |u| <= 40 Nm (tests/test_constraints.py::
# test_kuka_torque_limited_ee_solve), at N = 16 as there; the JAX side on its
# spatial-algebra CPU core (the port's preset default is the kernel core,
# plain versions on the CPU)
KUKA_GOAL = [0.3, -0.3, 0.9]
KUKA_ITERS = 6


def test_kuka_torque_limited_first_outer_solve_matches_jax(monkeypatch):
    """The first outer solve (lam = 0, mu = 10) of the torque-limited Kuka
    solve: the same alphas, J within J_RTOL_CORES.  Capped at KUKA_ITERS
    iterations, a prefix of the same solve (the port's plain kernels take
    ~1 s an iteration on a CPU; the JAX side's compile, ~32 s, is the same
    at any cap): four rejections, then an accepted step."""
    rp = ref_presets.kuka_ee(num_time_steps=16, m_blocks=2, num_alpha=4)
    assert "rbd" in rp.plant.name
    cfg_r = dataclasses.replace(rp.cfg, max_iter=KUKA_ITERS)
    con_r = ref.BoxConstraints(n_state=14, n_ctrl=7, u_min=[-40.0] * 7, u_max=[40.0] * 7)
    ref_outs = []
    monkeypatch.setattr(ref_solver_module, "make_ilqr_solver",
                        _recording(ref_solver_module.make_ilqr_solver, ref_outs))
    ref.solve_al(rp.plant, rp.cost, cfg_r, jnp.zeros((16, 14)), jnp.zeros((16, 7)),
                 ref_presets.ee_goal(KUKA_GOAL), con_r, ref.ALConfig(max_outer=1))
    prob = presets.kuka_ee(num_time_steps=16, m_blocks=2, num_alpha=4)
    cfg = dataclasses.replace(interop.solver_config(cfg_r), pallas_riccati=True)
    outs = []
    monkeypatch.setattr(constraints, "make_ilqr_solver",
                        _recording(constraints.make_ilqr_solver, outs))
    constraints.solve_al(prob.plant, prob.cost, cfg, torch.zeros(16, 14), torch.zeros(16, 7),
                         presets.ee_goal(KUKA_GOAL, device="cpu"),
                         interop.box_constraints(con_r), constraints.ALConfig(max_outer=1))
    (oj, oa), (rj, ra) = _traces(outs[0]), _traces(jax.device_get(ref_outs[0]))
    np.testing.assert_array_equal(oa, ra)
    np.testing.assert_allclose(oj, rj, rtol=J_RTOL_CORES)
    assert np.any(oa[1:] >= 0)                              # something accepted


def test_interop_round_trip():
    """A JAX BoxConstraints and a nested AL goal carried across."""
    con_r = ref.BoxConstraints(n_state=14, n_ctrl=7, u_max=[40.0] * 7, x_min=[-2.0] * 14)
    con = interop.box_constraints(con_r)
    assert (con.u_min, con.x_max) == (None, None)
    _exact(con.u_max, con_r.u_max)
    _exact(con.x_min, con_r.x_min)
    assert con.u_max.dtype == np.float32 and con.n_c == con_r.n_c
    g_r = {"base": ref_presets.ee_goal(KUKA_GOAL),
           "lam": jnp.arange(16 * con.n_c, dtype=jnp.float32).reshape(16, con.n_c),
           "mu": jnp.asarray(50.0, jnp.float32)}
    g = interop.goal(g_r)
    assert set(g) == {"base", "lam", "mu"} and set(g["base"]) == {"ee_goal", "x_target"}
    for got, want in ((g["base"]["ee_goal"], g_r["base"]["ee_goal"]),
                      (g["base"]["x_target"], g_r["base"]["x_target"]),
                      (g["lam"], g_r["lam"]), (g["mu"], g_r["mu"])):
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        _exact(got, want)
    assert g["mu"].shape == ()
