"""The port's pick-and-place task (parallel_ddp_tpu_torch/tasks/) against the
JAX package's on the same seeded inputs.

  * `sample_waypoints` and the two cost sets: equal values;
  * `PickAndPlaceGoalNode`: one status sequence fed to both packages' nodes
    over a recording bus, with one `ee_pos_fn`: the same bytes published on
    the same channels in the same order, and the same settle records;
  * `make_pick_place_device_loop` at kuka_ee(num_time_steps=16, m_blocks=2,
    num_alpha=4) with the short settings of tests/test_pick_and_place.py's
    device-loop test (two near-home waypoints, wide settle bands, 200 Hz
    plant, 50 ms control period; 10 of its 25 steps: the loops settle both
    waypoints within 2), both loops started at rest at the home pose (zero
    controls and gains: dynamically exact in the gravity-compensated plant,
    the cold start left out): the JAX package runs its `rbd` core
    (tests/test_torch_mpc.py's `_controllers`), the port its main-path
    "cuda" core on CPU tensors (the kernels' plain versions), so they differ
    in float32 rounding: equal wp_idx, accepted, ok and waypoints_done, J
    within rtol 2e-3, x within atol 1e-3, e_norm within atol 1e-4 (the
    closed-loop tolerances of tests/test_torch_mpc.py).  The JAX loop's
    per-step J / accepted / ok, which its result does not carry, are
    recorded by a wrapper around its controller's `_mpc_step`
    (`jax.debug.callback`);
  * the loop's graph route (`graphs.emulate()`, results copied out in
    chunks of 3 steps) against its host loop: bit for bit, no host reads."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from parallel_ddp_tpu.mpc import driver as ref_driver
from parallel_ddp_tpu.presets import kuka_ee as ref_kuka_ee
from parallel_ddp_tpu.runtime import messages as ref_msg
from parallel_ddp_tpu.tasks import pick_and_place as ref_pnp
from parallel_ddp_tpu_torch import graphs, interop
from parallel_ddp_tpu_torch.mpc import device_loop, driver
from parallel_ddp_tpu_torch.presets import kuka_ee
from parallel_ddp_tpu_torch.runtime import messages as msg
from parallel_ddp_tpu_torch.tasks import pick_and_place as pnp

N, A, M_BLOCKS = 16, 4, 2
MPC = dict(max_iters_per_solve=2)
WPS = np.asarray([[0.1, 0.1, 1.2], [0.1, -0.1, 1.2]], np.float32)
TASK = dict(e_norm_lim=0.35, v_norm_lim=2.0)
SIM_RATE, PERIOD, STEPS = 200.0, 0.05, 10
J_RTOL, X_ATOL, E_ATOL = 2e-3, 1e-3, 1e-4


@pytest.mark.parametrize("n,seed", [(1, 0), (6, 0), (8, 3)])
def test_sample_waypoints_equal(n, seed):
    got = pnp.sample_waypoints(pnp.PickAndPlaceConfig(), n, np.random.default_rng(seed))
    want = ref_pnp.sample_waypoints(ref_pnp.PickAndPlaceConfig(), n,
                                    np.random.default_rng(seed))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pnp.sample_waypoints(pnp.PickAndPlaceConfig(), n),
                                  ref_pnp.sample_waypoints(ref_pnp.PickAndPlaceConfig(), n))


def test_cost_sets_and_config_equal():
    assert tuple(pnp.default_weights()) == tuple(ref_pnp.default_weights())
    assert tuple(pnp.close_weights()) == tuple(ref_pnp.close_weights())
    assert dataclasses.asdict(pnp.PickAndPlaceConfig()) == dataclasses.asdict(
        ref_pnp.PickAndPlaceConfig())


class RecordingBus:
    """A bus that records what is published, in order, and delivers nothing."""

    def __init__(self):
        self.sent = []

    def subscribe(self, channel):
        pass

    def publish(self, channel, payload):
        self.sent.append((channel, bytes(payload)))


def _status_sequence(goal_of):
    """Statuses (a generator: each reads the node's goal when it is made)
    that walk the state machine through every branch twice: far away, close
    (the close cost set), settled (goal, clearVars params, default costs),
    moving toward the new goal (shift params), in the band but too fast to
    settle; the fake FK puts the EE at the first three joint coordinates."""
    qd0, t = np.zeros(7, np.float32), 0.0
    q = lambda q3: np.concatenate([q3, np.zeros(4)]).astype(np.float32)
    for _ in range(2):
        g = goal_of()
        for q3 in (np.zeros(3), g + 0.15 / np.sqrt(3.0), g + 0.15 / np.sqrt(3.0), g):
            t += 0.25
            yield t, q(q3), qd0
        g_new = goal_of()
        t += 0.25
        yield t, q(0.5 * (g_new + g)), qd0
        t += 0.25
        yield t, q(g_new), np.full(7, 1.0, np.float32)


def test_goal_node_publishes_the_same_bytes():
    fk = lambda q: np.asarray(q[:3], np.float32)
    cfg_kw = dict(e_norm_lim=0.10, v_norm_lim=0.10, iter_limit=7, time_limit_ms=5.0)
    buses = RecordingBus(), RecordingBus()
    port = pnp.PickAndPlaceGoalNode(buses[0], fk, pnp.PickAndPlaceConfig(**cfg_kw),
                                    rng=np.random.default_rng(42))
    ref = ref_pnp.PickAndPlaceGoalNode(buses[1], fk, ref_pnp.PickAndPlaceConfig(**cfg_kw),
                                       rng=np.random.default_rng(42))
    for t, q, qd in _status_sequence(lambda: port.goal.copy()):
        port.handle_status(msg.Status(t, q, qd))
        ref.handle_status(ref_msg.Status(t, q, qd))
        np.testing.assert_array_equal(port.goal, ref.goal)
    channels = [ch for ch, _ in buses[0].sent]
    assert {"GOAL_CHANNEL", "SOLVER_PARAMS_CHANNEL", "COST_PARAMS_CHANNEL"} <= set(channels)
    assert channels.count("GOAL_CHANNEL") == 2
    assert buses[0].sent == buses[1].sent
    assert port.settle_times() == ref.settle_times() and len(port.settle_times()) == 2
    for a, b in zip(port.records, ref.records):
        np.testing.assert_array_equal(a.goal, b.goal)
        assert (a.t_set, a.t_settled) == (b.t_set, b.t_settled)


def _controllers():
    """(JAX, port) controllers on one configuration; the JAX one on its `rbd`
    core, at most 8 rho retries (as tests/test_torch_mpc.py)."""
    ref = ref_kuka_ee(num_time_steps=N, m_blocks=M_BLOCKS, num_alpha=A)
    assert "rbd" in ref.plant.name
    ref_cfg = dataclasses.replace(ref.cfg, max_bp_retries=8)
    prob = kuka_ee(num_time_steps=N, m_blocks=M_BLOCKS, num_alpha=A)
    cfg = dataclasses.replace(interop.solver_config(ref_cfg), pallas_riccati=True)
    return (ref_driver.MPCController(ref.plant, ref.cost, ref_cfg, ref_driver.MPCConfig(**MPC)),
            driver.MPCController(prob.plant, prob.cost, cfg, driver.MPCConfig(**MPC)))


def _start_state():
    """At rest at the home pose, zero controls and gains (zero defects)."""
    z = lambda *shape: jax.numpy.zeros(shape, jax.numpy.float32)
    return ref_driver.MPCState(x=z(N, 14), u=z(N, 7), K=z(N, 7, 14), P=z(N, 14, 14),
                               p=z(N, 14), d=z(N, 14), t0=jax.numpy.float32(0.0),
                               fails=jax.numpy.int32(0))


@functools.lru_cache(maxsize=None)
def _reference_loop():
    """The JAX device loop from `_start_state`, with each step's (J,
    accepted, ok) recorded; returns (result, records)."""
    ref, _ = _controllers()
    records = []
    inner = ref._mpc_step

    def recording_step(*args):
        st_new, info = inner(*args)
        jax.debug.callback(lambda j, a, o: records.append((float(j), bool(a), bool(o))),
                           info.J, info.accepted, info.ok, ordered=True)
        return st_new, info

    ref._mpc_step = recording_step
    loop = ref_pnp.make_pick_place_device_loop(ref, WPS, ref_pnp.PickAndPlaceConfig(**TASK),
                                               sim_rate_hz=SIM_RATE, control_period_s=PERIOD)
    res = jax.device_get(loop(_start_state(), np.zeros(14, np.float32), 0.0, STEPS))
    return res, records


def _port_loop():
    _, port = _controllers()
    run = pnp.make_pick_place_device_loop(port, WPS, pnp.PickAndPlaceConfig(**TASK),
                                          sim_rate_hz=SIM_RATE, control_period_s=PERIOD)
    return run, interop.mpc_state(_start_state())


def test_device_loop_matches_reference():
    want, records = _reference_loop()
    run, st = _port_loop()
    got = run(st, torch.zeros(14), 0.0, STEPS)
    assert len(records) == STEPS
    ref_j, ref_acc, ref_ok = (np.asarray(c) for c in zip(*records))
    np.testing.assert_array_equal(got.wp_idx.numpy(), np.asarray(want.wp_idx))
    assert int(got.waypoints_done) == int(want.waypoints_done) == len(WPS)
    assert got.wp_idx[0] == 0 and got.wp_idx[-1] >= 1
    np.testing.assert_array_equal(got.accepted.numpy(), ref_acc)
    np.testing.assert_array_equal(got.ok.numpy(), ref_ok)
    np.testing.assert_allclose(got.J.numpy(), ref_j, rtol=J_RTOL)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=X_ATOL)
    np.testing.assert_allclose(got.e_norm.numpy(), np.asarray(want.e_norm), rtol=0,
                               atol=E_ATOL)
    np.testing.assert_allclose(got.v_norm.numpy(), np.asarray(want.v_norm), rtol=0,
                               atol=X_ATOL)
    assert got.host_syncs > 0


def test_device_loop_graph_route_is_the_host_loop(monkeypatch):
    """The captured control step (static buffers, the device step index and
    waypoint index, results copied out 3 steps at a time) replayed under
    `graphs.emulate()` against the host loop: bit for bit, no host reads,
    one capture for two runs of different lengths."""
    monkeypatch.setattr(device_loop, "STEPS_PER_LOAD", 3)
    run, st = _port_loop()
    steps = 4
    host = run(st, torch.zeros(14), 0.0, steps)
    with graphs.emulate():
        got = run(st, torch.zeros(14), 0.0, steps)
        again = run(st, torch.zeros(14), 0.0, 2)
    assert got.host_syncs == 0 and len(run.graphs) == 1
    for name in ("x", "e_norm", "v_norm", "wp_idx", "waypoints_done", "J", "accepted", "ok"):
        torch.testing.assert_close(getattr(got, name), getattr(host, name), rtol=0, atol=0,
                                   equal_nan=True, msg=name)
        if name != "waypoints_done":
            torch.testing.assert_close(getattr(again, name), getattr(host, name)[:2], rtol=0,
                                       atol=0, msg=name)
    for a, b in zip(got.state, host.state):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
