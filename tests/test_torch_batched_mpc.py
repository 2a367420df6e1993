"""The port's fleet MPC entry points (`MPCController.init_state_batch`,
`step_batch`) and the closed loop's goal pytrees, on the CPU at
kuka_ee(num_time_steps=16, m_blocks=2, num_alpha=4):

  * `init_state_batch` and `step_batch` against the reference's at B = 3 (its
    spatial-algebra `rbd` core, as tests/test_torch_mpc.py): per scenario the
    same accept decision, shift, iterations and ok flag, J within J_RTOL;
    each scenario of the port's fleet step equals its single step bit for
    bit;
  * `step_batch` through its graph route under `graphs.emulate()`: the host
    route bit for bit, no host reads, and a new weight value takes effect
    with no new capture;
  * a closed loop whose cost takes a bare-array goal against the dict-goal
    loop, on the CPU and under `emulate()`.
"""

import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_ddp_tpu.mpc import driver as ref_driver
from parallel_ddp_tpu.presets import fig8_weights as ref_fig8_weights
from parallel_ddp_tpu.presets import kuka_ee as ref_kuka_ee
from parallel_ddp_tpu_torch import graphs, interop
from parallel_ddp_tpu_torch.costs.base import CostModel
from parallel_ddp_tpu_torch.mpc import device_loop, driver
from parallel_ddp_tpu_torch.presets import ee_goal, fig8_weights, figure8_goal, kuka_ee

N, M, A = 16, 2, 4
# spatial-algebra vs scalar-channel float32 dynamics (tests/test_torch_mpc.py)
J_RTOL = 2e-3
X_INIT = np.zeros(14, np.float32)
X_INIT[1], X_INIT[3], X_INIT[5] = np.pi / 4, -np.pi / 4, np.pi / 4


def _same(a, b, name=""):
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True, msg=name)


def _problem():
    """(plant, cost, config) with at most 2 rho retries: a masked run makes
    all of them in every iteration."""
    prob = kuka_ee(num_time_steps=N, m_blocks=M, num_alpha=A)
    return prob.plant, prob.cost, dataclasses.replace(prob.cfg, pallas_riccati=True,
                                                      max_bp_retries=2)


def _fleet_inputs(B=3):
    rng = np.random.default_rng(2)
    xs = (X_INIT + rng.normal(0, 0.02, (B, 14))).astype(np.float32)
    xyz = np.stack([figure8_goal(1.0 + 0.3 * b)[0] for b in range(B)]).astype(np.float32)
    ee = np.concatenate([xyz, np.zeros_like(xyz)], axis=1)
    return xs, ee, np.tile(X_INIT, (B, 1))


def test_fleet_mpc_matches_reference():
    """init_state_batch and step_batch at B = 3 (the reference's
    tests/test_mpc.py fleet test on the Kuka): per scenario the same accept
    decision, shift, iterations and ok flag, J within J_RTOL; each scenario
    of the port's fleet step equals its single step bit for bit."""
    mpc = dict(max_iters_per_solve=3)
    ref = ref_kuka_ee(num_time_steps=N, m_blocks=M, num_alpha=A)
    assert "rbd" in ref.plant.name
    ref_cfg = dataclasses.replace(ref.cfg, max_bp_retries=2)
    ref_ctrl = ref_driver.MPCController(ref.plant, ref.cost, ref_cfg, ref_driver.MPCConfig(**mpc))
    plant, cost, cfg = _problem()
    assert dataclasses.replace(interop.solver_config(ref_cfg), pallas_riccati=True) == cfg
    ctrl = driver.MPCController(plant, cost, cfg, driver.MPCConfig(**mpc))
    xs, ee, xt = _fleet_inputs()
    ref_goals = {"ee_goal": jnp.asarray(ee), "x_target": jnp.asarray(xt)}
    goals = {"ee_goal": torch.as_tensor(ee), "x_target": torch.as_tensor(xt)}
    ref_w, w = ref_fig8_weights(), fig8_weights()
    assert interop.cost_weights(ref_w) == w
    t_nows = np.asarray([0.01, 0.04, 0.07], np.float32)

    ref_sts = ref_ctrl.init_state_batch(xs, np.zeros(3), ref_goals, ref_w, warmup_iters=4)
    sts = ctrl.init_state_batch(torch.as_tensor(xs), torch.zeros(3), goals, w, warmup_iters=4)
    assert sts.t0.shape == (3,) and sts.fails.shape == (3,)
    np.testing.assert_allclose(sts.x.numpy(), np.asarray(ref_sts.x), rtol=1e-3, atol=1e-3)
    # both start the step from the reference's state
    start = interop.mpc_state(ref_sts)
    ref_out, ref_info = ref_ctrl.step_batch(ref_sts, xs, t_nows, ref_goals, ref_w)
    out, info = ctrl.step_batch(start, torch.as_tensor(xs), torch.as_tensor(t_nows), goals, w)
    for name in ("accepted", "shift_steps", "iters", "ok"):
        np.testing.assert_array_equal(getattr(info, name).numpy(),
                                      np.asarray(getattr(ref_info, name)), err_msg=name)
    np.testing.assert_allclose(info.J.numpy(), np.asarray(ref_info.J), rtol=J_RTOL)
    np.testing.assert_allclose(out.t0.numpy(), np.asarray(ref_out.t0), rtol=1e-6)
    np.testing.assert_array_equal(out.fails.numpy(), np.asarray(ref_out.fails))
    for b in range(3):
        one_st, one_info = ctrl.step(driver.MPCState(*(a[b] for a in start)),
                                     torch.as_tensor(xs[b]), float(t_nows[b]),
                                     {k: v[b] for k, v in goals.items()}, w)
        for a, c in zip(one_st + one_info, out + info):
            _same(c[b], a, f"scenario {b}")


def test_graph_route_of_the_fleet_step():
    """step_batch and the single step through their graph routes: the host
    route bit for bit, no host reads, and a weight change makes no capture."""
    ctrl = driver.MPCController(*_problem(), driver.MPCConfig(max_iters_per_solve=2))
    xs, ee, xt = (torch.as_tensor(a) for a in _fleet_inputs())
    goals = {"ee_goal": ee, "x_target": xt}
    w, w2 = fig8_weights(), fig8_weights()._replace(q_ee1=100.0)
    sts = ctrl.init_state_batch(xs, torch.zeros(3), goals, w, warmup_iters=2)
    t = torch.tensor([0.01, 0.02, 0.05])
    want = [ctrl.step_batch(sts, xs, t, goals, ww) for ww in (w, w2)]
    with graphs.emulate():
        got = [ctrl.step_batch(sts, xs, t, goals, ww) for ww in (w, w2)]
        assert len(ctrl.graphs) == 1 and ctrl.host_syncs == 0
    for g, r in zip(got, want):
        for a, b in zip(g[0] + g[1], r[0] + r[1]):
            _same(a, b)
    assert not torch.equal(got[0][1].J, got[1][1].J)


def _bare_goal_cost(cost):
    """The EE cost on a bare-array goal [ee_goal (6); x_target (14)]."""
    split = lambda g: {"ee_goal": g[..., :6], "x_target": g[..., 6:]}
    return CostModel(
        name="ee_cost_bare_goal",
        stage=lambda x, u, k, g, w: cost.stage(x, u, k, split(g), w),
        quad=lambda x, u, k, g, w: cost.quad(x, u, k, split(g), w))


@pytest.mark.parametrize("route", ["host", "graph"])
def test_loop_takes_a_bare_array_goal(route, monkeypatch):
    """The device loop over a bare-array goal (its tracking error is taken
    from the array's first three entries, as the reference does) equals the
    dict-goal loop; through the graph route a changed weight value takes
    effect and adds no capture."""
    monkeypatch.setattr(device_loop, "STEPS_PER_LOAD", 2)
    plant, cost, cfg = _problem()
    mpc = driver.MPCConfig(max_iters_per_solve=2)
    ctrl = driver.MPCController(plant, cost, cfg, mpc)
    ctrl_bare = driver.MPCController(plant, _bare_goal_cost(cost), cfg, mpc)
    w = fig8_weights()
    g0 = ee_goal((0.0, -0.55, 0.35), x_target=X_INIT, device="cpu")
    st = ctrl.init_state(torch.as_tensor(X_INIT), goal=g0, weights=w, warmup_iters=2)
    goals = {k: torch.stack([v] * 2) for k, v in g0.items()}
    goals["ee_goal"] = goals["ee_goal"] + torch.linspace(0, 0.02, 2)[:, None]
    bare = torch.cat([goals["ee_goal"], goals["x_target"]], dim=-1)
    run = device_loop.make_device_mpc_loop(ctrl, sim_rate_hz=200.0, control_period_s=0.02)
    run_bare = device_loop.make_device_mpc_loop(ctrl_bare, sim_rate_hz=200.0,
                                                control_period_s=0.02)
    x0 = torch.as_tensor(X_INIT)
    with graphs.emulate() if route == "graph" else contextlib.nullcontext():
        want = run(st, x0, 0.0, goals, w)
        got = run_bare(st, x0, 0.0, bare, w)
        if route == "graph":
            moved = run_bare(st, x0, 0.0, bare, w._replace(q_ee1=100.0))
            assert len(run_bare.graphs) == 1 and got.host_syncs == 0
            assert not torch.equal(moved.J, got.J)
    for name in ("x", "ee_err", "J", "accepted", "ok"):
        _same(getattr(got, name), getattr(want, name), name)
    for a, b in zip(got.state, want.state):
        _same(a, b)
