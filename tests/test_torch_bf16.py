"""The reduced-precision forward path of the port (`SolverConfig.bf16_rollout`,
`bf16_cost`; parallel_ddp_tpu_torch/solver.py) against the JAX package's
(parallel_ddp_tpu/solver.py:122-141, 177-183, 204-206), on the CPU at small
sizes.

  * the twins of tests/test_bf16.py's four tests on the port, with their
    bands, on the core the JAX tests run on the CPU (the Kuka's "auto" core
    is the spatial-algebra `rbd` core in both packages, whose float32
    constants promote a bfloat16 input, as the JAX package's do);
  * the port's bfloat16 step against the JAX package's on the same seeded
    inputs (the Kuka on `rbd`, the pendulum), within 0.03 of max(|f32|, 1),
    the JAX step oracle's band; the pendulum's bfloat16 swing-up J within
    2 % of the JAX package's;
  * the main path's "cuda" core, whose dynamics and kinematics are bfloat16
    throughout (the scalar-channel core, as on the JAX package's TPU path):
    its rollout op's plain version against the loop it stands for, lane by
    lane, bit for bit; the JAX test's trace bands for alphas and J (its
    states part from the float32 solve's by more than the JAX test's 0.05:
    PERF.md §6);
  * bf16_cost: J0 in float32, the float32 sum of the wrapped stage; the
    derivative stage and backward pass the float32 solver's, bit for bit;
    each stage's output dtype that of the JAX package's stage;
  * the flags through the batched solver (B = 3 against three single
    solves, bit for bit), an MPC step and the AL solver, and the card's
    graph route under `graphs.emulate()`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from parallel_ddp_tpu import constraints as ref_constraints
from parallel_ddp_tpu.config import CostWeights as RefCostWeights
from parallel_ddp_tpu.ops.integrators import make_step as ref_make_step
from parallel_ddp_tpu.presets import ee_goal as ref_ee_goal
from parallel_ddp_tpu.presets import kuka_ee as ref_kuka_ee
from parallel_ddp_tpu.presets import pendulum_swingup as ref_pendulum_swingup
from parallel_ddp_tpu.solver import make_ilqr_solver as ref_make_solver
from parallel_ddp_tpu_torch import constraints, graphs
from parallel_ddp_tpu_torch.config import weights_of, weights_tensor
from parallel_ddp_tpu_torch.mpc import driver
from parallel_ddp_tpu_torch.ops import cuda_rollout
from parallel_ddp_tpu_torch.ops.cuda_rollout import rollout_plain
from parallel_ddp_tpu_torch.ops.integrators import make_bf16_step, make_step
from parallel_ddp_tpu_torch.parallel.sharding import make_batched_solver
from parallel_ddp_tpu_torch.presets import ee_goal, kuka_ee, pendulum_swingup
from parallel_ddp_tpu_torch.solver import bf16_stage, make_ilqr_solver

N, M, A = 16, 2, 4
GOAL = (0.3, -0.3, 0.9)
BOTH = dict(bf16_rollout=True, bf16_cost=True)
# tests/test_bf16.py's bands
STEP_BAND = 0.03        # one bfloat16 step against float32: |err| / max(|f32|, 1)
J_RTOL = 6e-2           # the J trace after 6 iterations
X_ATOL = 0.05           # the final trajectory
SWING_RTOL = 0.02       # the pendulum swing-up's J
# the AL loop's final violation under both flags against the JAX package's
# on the same problem: the two round the bfloat16 step at other places
# (XLA's CPU fusion against torch op by op), so their line searches part in
# the first outer solve and only the level at which the loop stalls is held
AL_VIOL_RTOL = 0.25


def _same(a, b, name=""):
    a, b = torch.as_tensor(np.asarray(a)), torch.as_tensor(np.asarray(b))
    assert a.shape == b.shape and a.dtype == b.dtype, name
    if a.is_floating_point():
        a, b = a.view(torch.int32 if a.dtype == torch.float32 else torch.int16), \
            b.view(torch.int32 if b.dtype == torch.float32 else torch.int16)
    assert torch.equal(a, b), name


# -- tests/test_bf16.py:23 --------------------------------------------------

def test_bf16_rollout_pendulum_still_swings_up():
    """The pendulum swing-up with a bfloat16 rollout reaches [pi, 0] within
    0.05 and J within 2 % of the float32 solve's (the JAX test's bars), and
    of the JAX package's bfloat16 solve's."""
    prob = pendulum_swingup(num_time_steps=64, total_time=2.0, m_blocks=2, num_alpha=8)
    cfg32 = dataclasses.replace(prob.cfg, max_iter=30)
    cfg16 = dataclasses.replace(cfg32, bf16_rollout=True)
    goal = torch.tensor([np.pi, 0.0])
    x0, u0 = torch.zeros(64, 2), torch.zeros(64, 1)
    o32 = make_ilqr_solver(prob.plant, prob.cost, cfg32)(x0, u0, goal, initial_rollout=True)
    o16 = make_ilqr_solver(prob.plant, prob.cost, cfg16)(x0, u0, goal, initial_rollout=True)
    np.testing.assert_allclose(o16.x[-1].numpy(), [np.pi, 0.0], atol=0.05)
    assert abs(float(o16.J) - float(o32.J)) / float(o32.J) < SWING_RTOL

    ref = ref_pendulum_swingup(num_time_steps=64, total_time=2.0, m_blocks=2, num_alpha=8)
    ref16 = ref_make_solver(ref.plant, ref.cost, dataclasses.replace(
        ref.cfg, max_iter=30, bf16_rollout=True))(
        jnp.zeros((64, 2)), jnp.zeros((64, 1)), jnp.asarray([np.pi, 0.0], jnp.float32),
        initial_rollout=True)
    assert abs(float(o16.J) - float(ref16.J)) / float(ref16.J) < SWING_RTOL


# -- tests/test_bf16.py:42 --------------------------------------------------

def _kuka_pair(core, **flags):
    prob = kuka_ee(num_time_steps=N, m_blocks=M, num_alpha=A, core=core)
    cfg32 = dataclasses.replace(prob.cfg, max_iter=6, tol_cost=0.0)
    x0, u0, goal = torch.zeros(N, 14), torch.zeros(N, 7), ee_goal(GOAL, device="cpu")
    o32 = make_ilqr_solver(prob.plant, prob.cost, cfg32)(x0, u0, goal, initial_rollout=True)
    o16 = make_ilqr_solver(prob.plant, prob.cost, dataclasses.replace(cfg32, **flags))(
        x0, u0, goal, initial_rollout=True)
    return o32, o16


def _trace_bands(o32, o16):
    """The JAX test's first two bars: the same alphas, J within J_RTOL."""
    _same(o16.alpha_trace, o32.alpha_trace, "alpha_trace")
    j32, j16 = (np.asarray(o.J_trace, np.float64) for o in (o32, o16))
    m = ~np.isnan(j32) & ~np.isnan(j16)
    assert m.sum() >= 3
    np.testing.assert_allclose(j16[m], j32[m], rtol=J_RTOL)


def test_bf16_cost_trace_parity_kuka():
    """tests/test_bf16.py:42 on the port, on the core the JAX test runs on
    the CPU: both flags against float32 at tol_cost = 0 take the same
    alphas, J within 6e-2, x within 0.05."""
    o32, o16 = _kuka_pair("auto", **BOTH)
    _trace_bands(o32, o16)
    np.testing.assert_allclose(o16.x.numpy(), o32.x.numpy(), rtol=0.0, atol=X_ATOL)


def test_bf16_trace_parity_on_the_kernel_core():
    """The same solves on the main path's "cuda" core (its ops' plain
    versions on CPU tensors): the same alphas and J within 6e-2.  Its
    bfloat16 dynamics are the scalar-channel core's throughout, so its
    trajectory parts from the float32 one by more than the rbd core's
    (~0.17 in a joint velocity here)."""
    o32, o16 = _kuka_pair("cuda", **BOTH)
    _trace_bands(o32, o16)
    assert bool(torch.isfinite(o16.x).all())


# -- tests/test_bf16.py:74 --------------------------------------------------

def _step_inputs(n, m, sx, su):
    rng = np.random.default_rng(0)
    return (rng.normal(0, sx, (32, n)).astype(np.float32),
            rng.normal(0, su, (32, m)).astype(np.float32))


@pytest.mark.parametrize("plant", ["kuka_rbd", "pendulum"])
def test_bf16_rollout_step_oracle(plant):
    """One bfloat16 step against float32 on seeded states within the JAX
    step oracle's 0.03 of max(|f32|, 1) (tests/test_bf16.py:74, its inputs),
    and against the JAX package's bfloat16 step on the same inputs within
    the same band."""
    if plant == "kuka_rbd":
        prob = kuka_ee(num_time_steps=N, m_blocks=M, num_alpha=A, core="rbd")
        ref = ref_kuka_ee(num_time_steps=N, m_blocks=M, num_alpha=A)
        assert "rbd" in ref.plant.name and "rbd" in prob.plant.name
        x, u = _step_inputs(14, 7, 0.5, 2.0)
    else:
        prob = pendulum_swingup(num_time_steps=N, m_blocks=M, num_alpha=A)
        ref = ref_pendulum_swingup(num_time_steps=N, m_blocks=M, num_alpha=A)
        x, u = _step_inputs(2, 1, 1.0, 2.0)
    step = make_step(prob.plant, prob.cfg.integrator, prob.cfg.dt)
    f32 = step(torch.as_tensor(x), torch.as_tensor(u)).numpy()
    f16 = make_bf16_step(step)(torch.as_tensor(x), torch.as_tensor(u))
    assert f16.dtype == torch.float32
    scale = np.maximum(np.abs(f32), 1.0)
    assert float((np.abs(f16.numpy() - f32) / scale).max()) < STEP_BAND

    ref_step = ref_make_step(ref.plant, ref.cfg.integrator, ref.cfg.dt)
    ref16 = np.asarray(jax.vmap(
        lambda xi, ui: ref_step(xi.astype(jnp.bfloat16),
                                ui.astype(jnp.bfloat16)).astype(jnp.float32))(
        jnp.asarray(x), jnp.asarray(u)))
    assert float((np.abs(f16.numpy() - ref16) / scale).max()) < STEP_BAND


# -- tests/test_bf16.py:97 --------------------------------------------------

def test_bf16_takes_precedence_over_fused_rollout():
    """Under bf16_rollout the float32 fused-rollout factory is never
    consulted and the bfloat16 one is; under float32 the other way round."""
    calls = []

    def factory(tag):
        def make(integrator, dt, n, m, a):
            calls.append(tag)
            return None
        return make

    prob = pendulum_swingup(num_time_steps=N, m_blocks=M, num_alpha=A)
    plant = dataclasses.replace(prob.plant, fused_rollout=factory("f32"),
                                fused_rollout_bf16=factory("bf16"))
    make_ilqr_solver(plant, prob.cost, dataclasses.replace(prob.cfg, bf16_rollout=True))
    assert calls == ["bf16"]
    make_ilqr_solver(plant, prob.cost, prob.cfg)
    assert calls == ["bf16", "f32"]
    make_ilqr_solver(plant, prob.cost, dataclasses.replace(prob.cfg, bf16_cost=True))
    assert calls == ["bf16", "f32", "f32"]     # bf16_cost alone keeps the float32 rollout


def test_kuka_solver_takes_the_bf16_rollout_op():
    """On the Kuka's "cuda" core the solver's forward simulation under
    bf16_rollout is the rollout op's bfloat16 entry (on CPU tensors its plain
    version), and without it the float32 op."""
    prob = kuka_ee(num_time_steps=N, m_blocks=M, num_alpha=A)
    rng = np.random.default_rng(3)
    t = lambda *s: torch.as_tensor(rng.normal(0, 0.3, s).astype(np.float32))
    args = (t(A, N, 14), t(N, 7), t(N, 7, 14) * 0.1, t(N, 7), t(N, 14),
            torch.as_tensor(prob.cfg.alphas()))
    kw = dict(ee_type=1, gravity=0.0, integrator=1, dt=prob.cfg.dt, m_blocks=M)
    skip = (torch.arange(N).reshape(M, N // M) == N - 1).to(torch.uint8)
    for flags, plain in (({"bf16_rollout": True}, cuda_rollout.kuka_rollout_bf16_plain),
                         ({}, cuda_rollout.kuka_rollout_plain)):
        solver = make_ilqr_solver(prob.plant, prob.cost, dataclasses.replace(prob.cfg, **flags))
        for got, want in zip(solver.fused_sim(*args), plain(*args, skip, **kw)):
            _same(got, want)


# -- the rollout op's plain version ------------------------------------------

@pytest.mark.parametrize("integrator", [1, 3])
def test_bf16_rollout_plain_is_the_loop_lane_by_lane(integrator):
    """`kuka_rollout_bf16_plain` (what the kernel's bfloat16 entry is held
    to on the card) is `rollout_plain` of the soa step made bfloat16, run on
    each (alpha, shooting block) lane alone: bit for bit."""
    rng = np.random.default_rng(1)
    t = lambda s, *shape: torch.as_tensor(rng.normal(0, s, shape).astype(np.float32))
    nf = N // M
    dt = 0.5 / (N - 1)
    x_sw, u, K, du, xp = t(0.3, A, N, 14), t(1.0, N, 7), t(0.05, N, 7, 14), t(0.5, N, 7), \
        t(0.3, N, 14)
    alphas = torch.as_tensor(kuka_ee(num_time_steps=N, m_blocks=M, num_alpha=A).cfg.alphas())
    skip = (torch.arange(N).reshape(M, nf) == N - 1).to(torch.uint8)
    xs, us = cuda_rollout.kuka_rollout_bf16_plain(
        x_sw, u, K, du, xp, alphas, skip, ee_type=1, gravity=0.0, integrator=integrator,
        dt=dt, m_blocks=M)
    assert xs.shape == (A, M, nf, 14) and xs.dtype == torch.float32
    soa_plant = kuka_ee(core="soa").plant      # gravity-compensated, ee_type 1
    step16 = make_bf16_step(make_step(soa_plant, integrator, dt))
    for a in range(A):
        for b in range(M):
            k = slice(b * nf, (b + 1) * nf)
            # the lane alone, as a batch of one (the batched product's rounding)
            one = lambda t: t[None]
            x_l, u_l = rollout_plain(step16, one(x_sw[a, b * nf]), one(u[k]), one(K[k]),
                                     one(du[k]), one(xp[k]), one(alphas[a]), one(skip[b].bool()))
            _same(xs[a, b], x_l[0], f"x lane {a}, {b}")
            _same(us[a, b], u_l[0], f"u lane {a}, {b}")
    # the float32 op on the same inputs: a different result
    x32, _ = cuda_rollout.kuka_rollout_plain(
        x_sw, u, K, du, xp, alphas, skip, ee_type=1, gravity=0.0, integrator=integrator,
        dt=dt, m_blocks=M)
    assert not torch.equal(x32, xs)


# -- bf16_cost ----------------------------------------------------------------

def test_bf16_cost_j0_and_the_float32_derivatives():
    """Under bf16_cost J0 is float32 and is the float32 sum of the wrapped
    stage over the horizon; the derivative stage (H, g, AB) and the backward
    pass are the float32 solver's: after one iteration P, p and K equal
    the float32 solve's bit for bit, while J0 does not."""
    prob = kuka_ee(num_time_steps=N, m_blocks=M, num_alpha=A)
    cfg = dataclasses.replace(prob.cfg, tol_cost=0.0)
    x0, u0, goal = torch.zeros(N, 14), torch.zeros(N, 7), ee_goal(GOAL, device="cpu")
    w = weights_tensor(None, torch.device("cpu"), torch.float32)
    s32 = make_ilqr_solver(prob.plant, prob.cost, cfg)
    s16 = make_ilqr_solver(prob.plant, prob.cost, dataclasses.replace(cfg, bf16_cost=True))
    o32 = s32(x0, u0, goal, initial_rollout=False, iter_limit=1)
    o16 = s16(x0, u0, goal, initial_rollout=False, iter_limit=1)
    assert o16.J_trace.dtype == torch.float32
    stage = bf16_stage(prob.cost.stage)
    j0 = stage(x0[None], u0[None], torch.arange(N), goal, weights_of(w, x0)).sum(-1)[0]
    assert j0.dtype == torch.float32
    _same(o16.J_trace[0], j0, "J0")
    assert float(o16.J_trace[0]) != float(o32.J_trace[0])
    for name in ("P", "p", "K"):
        _same(getattr(o16, name), getattr(o32, name), name)


def test_bf16_stage_dtypes_follow_the_jax_package():
    """Each cost's stage on bfloat16 x and u returns the dtype the JAX
    package's returns (float32: the goal, the limits and the fixed weights
    are float32 arrays), with the value within 1e-3 of JAX's on the Kuka's
    rbd core and the pendulum (both round only x and u and the bfloat16
    |u|^2 term the same way; the sums' order differs)."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 0.5, (N, 14)).astype(np.float32)
    u = rng.normal(0, 2.0, (N, 7)).astype(np.float32)
    prob = kuka_ee(num_time_steps=N, m_blocks=M, num_alpha=A, core="auto")
    ref = ref_kuka_ee(num_time_steps=N, m_blocks=M, num_alpha=A)
    w = weights_of(weights_tensor(None, torch.device("cpu"), torch.float32))
    ks = torch.arange(N)
    got = prob.cost.stage(torch.as_tensor(x).bfloat16(), torch.as_tensor(u).bfloat16(), ks,
                          ee_goal(GOAL, device="cpu"), w)
    ref_goal = ref_ee_goal(list(GOAL))
    want = jax.vmap(lambda xk, uk, k: ref.cost.stage(xk, uk, k, ref_goal, RefCostWeights()))(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(u, jnp.bfloat16), jnp.arange(N))
    assert str(got.dtype).split(".")[-1] == str(want.dtype) == "float32"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3)

    pend = pendulum_swingup(num_time_steps=N, m_blocks=M, num_alpha=A)
    ref_p = ref_pendulum_swingup(num_time_steps=N, m_blocks=M, num_alpha=A)
    xp, up = x[:, :2], u[:, :1]
    got = pend.cost.stage(torch.as_tensor(xp).bfloat16(), torch.as_tensor(up).bfloat16(), ks,
                          torch.tensor([np.pi, 0.0]), w)
    want = jax.vmap(lambda xk, uk, k: ref_p.cost.stage(
        xk, uk, k, jnp.asarray([np.pi, 0.0], jnp.float32), RefCostWeights()))(
        jnp.asarray(xp, jnp.bfloat16), jnp.asarray(up, jnp.bfloat16), jnp.arange(N))
    assert str(got.dtype).split(".")[-1] == str(want.dtype) == "float32"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3)

    con = constraints.BoxConstraints(n_state=2, n_ctrl=1, u_min=[-1.0], u_max=[1.0])
    al = constraints.al_cost(pend.cost, con, N - 1)
    al_goal = {"base": torch.tensor([np.pi, 0.0]), "lam": torch.zeros(N, 2),
               "mu": torch.tensor(10.0)}
    assert al.stage(torch.as_tensor(xp).bfloat16(), torch.as_tensor(up).bfloat16(), ks,
                    al_goal, w).dtype == torch.float32


# -- the flags through every solver --------------------------------------------

GOALS = ((0.3, -0.3, 0.9), (0.35, -0.25, 0.85), (0.2, -0.4, 0.8))


def test_bf16_batched_solve_equals_single_solves():
    """A B = 3 batched solve with both flags against the three single solves
    of the same solver configuration: every output bit for bit."""
    prob = kuka_ee(num_time_steps=N, m_blocks=M, num_alpha=A)
    cfg = dataclasses.replace(prob.cfg, max_iter=4, tol_cost=0.0, pallas_riccati=True, **BOTH)
    goals = [ee_goal(g, device="cpu") for g in GOALS]
    batch = make_batched_solver(prob.plant, prob.cost, cfg)(
        torch.zeros(3, N, 14), torch.zeros(3, N, 7),
        {k: torch.stack([g[k] for g in goals]) for k in goals[0]})
    single = make_ilqr_solver(prob.plant, prob.cost, cfg)
    for b, goal in enumerate(goals):
        out = single(torch.zeros(N, 14), torch.zeros(N, 7), goal, initial_rollout=True)
        for name, a in out._asdict().items():
            _same(getattr(batch, name)[b], a, f"{name}[{b}]")


def test_bf16_mpc_step_and_its_graph_route():
    """An MPC controller with both flags: a cold start and one step on the
    host route, and the same step through the graph route
    (`graphs.emulate()`), bit for bit and with no host read."""
    prob = kuka_ee(num_time_steps=N, m_blocks=M, num_alpha=A)
    cfg = dataclasses.replace(prob.cfg, pallas_riccati=True, max_bp_retries=8, **BOTH)
    ctrl = driver.MPCController(prob.plant, prob.cost, cfg,
                                driver.MPCConfig(max_iters_per_solve=2))
    x_init = np.zeros(14, np.float32)
    x_init[1], x_init[3], x_init[5] = np.pi / 4, -np.pi / 4, np.pi / 4
    goal = ee_goal((0.0, -0.55, 0.35), x_target=x_init, device="cpu")
    st = ctrl.init_state(torch.as_tensor(x_init), goal=goal, warmup_iters=2)
    host = ctrl.step(st, torch.as_tensor(x_init), 0.01, goal)
    with graphs.emulate():
        got = ctrl.step(st, torch.as_tensor(x_init), 0.01, goal)
        assert ctrl.host_syncs == 0
    got, host = pytree.tree_leaves(got), pytree.tree_leaves(host)
    assert len(got) == len(host)
    for a, b in zip(got, host):
        if isinstance(a, torch.Tensor):
            _same(a, b)
            assert not a.is_floating_point() or bool(torch.isfinite(a).all())


def test_bf16_al_solver():
    """The AL solver with both flags on the pendulum swing-up with |u| <= 6,
    at the fixed-iteration shape the JAX config prescribes for bfloat16
    (tol_cost = 0; 3 outer iterations of 20): its inner solver takes the
    flags, the trajectory is finite, the outer loop lowers the violation, and
    its final violation is the JAX package's solve_al's with the same flags
    within AL_VIOL_RTOL.  Both stall near 0.24 where the float32 loop
    reaches ~2e-4 (scripts/torch_bf16_precision.py --jax; PERF.md §7)."""
    prob = pendulum_swingup(num_time_steps=64, total_time=2.0, m_blocks=2, num_alpha=8)
    con = constraints.BoxConstraints(n_state=2, n_ctrl=1, u_min=[-6.0], u_max=[6.0])
    cfg = dataclasses.replace(prob.cfg, max_iter=20, tol_cost=0.0, **BOTH)
    solver = constraints.make_al_solver(prob.plant, prob.cost, cfg, con,
                                        constraints.ALConfig(max_outer=3))
    assert solver.solver.cfg.bf16_rollout and solver.solver.cfg.bf16_cost
    out, info = solver(torch.zeros(64, 2), torch.zeros(64, 1), torch.tensor([np.pi, 0.0]))
    assert bool(torch.isfinite(out.x).all()) and bool(torch.isfinite(out.u).all())
    assert info["violations"][-1] < info["violations"][0]
    ref_prob = ref_pendulum_swingup(num_time_steps=64, total_time=2.0, m_blocks=2, num_alpha=8)
    _, ref_info = ref_constraints.solve_al(
        ref_prob.plant, ref_prob.cost, dataclasses.replace(ref_prob.cfg, max_iter=20,
                                                           tol_cost=0.0, **BOTH),
        jnp.zeros((64, 2)), jnp.zeros((64, 1)), jnp.asarray([np.pi, 0.0]),
        ref_constraints.BoxConstraints(n_state=2, n_ctrl=1, u_min=[-6.0], u_max=[6.0]),
        ref_constraints.ALConfig(max_outer=3))
    np.testing.assert_allclose(info["violations"][-1], ref_info["violations"][-1],
                               rtol=AL_VIOL_RTOL)


def test_bf16_and_float32_solvers_never_share_a_capture():
    """A bfloat16 solver and a float32 one of the same problem each capture
    their own graph (the cache is the solver's): under `graphs.emulate()`
    each holds one capture, and each replay gives its own host route's
    result bit for bit."""
    prob = kuka_ee(num_time_steps=N, m_blocks=M, num_alpha=A)
    cfg = dataclasses.replace(prob.cfg, pallas_riccati=True, tol_cost=0.0, max_iter=2,
                              max_bp_retries=2)
    s32 = make_ilqr_solver(prob.plant, prob.cost, cfg)
    s16 = make_ilqr_solver(prob.plant, prob.cost, dataclasses.replace(cfg, **BOTH))
    args = (torch.zeros(N, 14), torch.zeros(N, 7), ee_goal(GOAL, device="cpu"))
    host = [s(*args, initial_rollout=True) for s in (s32, s16)]
    with graphs.emulate():
        got = [s(*args, initial_rollout=True) for s in (s32, s16)]
        assert len(s32.graphs) == len(s16.graphs) == 1 and s32.graphs is not s16.graphs
    for g, h in zip(got, host):
        for name, a in g._asdict().items():
            _same(a, getattr(h, name), name)
    assert not torch.equal(got[0].J_trace, got[1].J_trace)
