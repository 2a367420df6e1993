"""The port's runtime plane (parallel_ddp_tpu_torch/runtime/) against the JAX
package's, on the same seeded inputs.

  * messages: every type, packed by both packages on both wires (native and
    lcm), gives equal bytes, and each package unpacks the other's bytes to
    equal fields; a Trajectory of tensors packs as its numpy twin;
  * `lcm_wire`: the same fingerprints, and framing, fragmentation and
    reassembly give equal bytes across the packages;
  * a port `PubSub` and a JAX `PubSub` on one non-default port deliver to
    each other on both wires (the port's bus library is built from
    `native/ddprt.cpp`); the port's `NativeTrajRunner` equals
    `mpc/controls.get_hardware_controls`;
  * `ee_goal_to_pytree` in its three modes; the solver node's goal always
    carries a 0-d int32 `cost_shift` leaf and keeps its graph signature when
    the shift toggles; a node solve under `graphs.emulate()` makes no new
    capture for a new goal, cost set, shift, iteration or time limit, and
    reads the host once a solve;
  * `SimulatorNode` takes both command flavours; `TrajPlaybackNode` and
    `StatusFilterNode` publish the JAX nodes' bytes for the same input;
  * a short CPU pendulum stack (solver, runner and simulator threads on a
    loopback bus), held to tests/test_runtime.py's assertions for its stack.

Bus ports 7901-7912: the JAX package's runtime tests use 7767-7780 and 7811."""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from parallel_ddp_tpu.config import CostWeights as RefCostWeights
from parallel_ddp_tpu.models import pendulum as ref_pendulum
from parallel_ddp_tpu.runtime import lcm_wire as ref_lw
from parallel_ddp_tpu.runtime import messages as ref_msg
from parallel_ddp_tpu.runtime import nodes as ref_nodes
from parallel_ddp_tpu.runtime.pubsub import PubSub as RefPubSub
from parallel_ddp_tpu_torch import graphs
from parallel_ddp_tpu_torch.config import CostWeights, SolverConfig
from parallel_ddp_tpu_torch.costs.joint import pendulum_cost
from parallel_ddp_tpu_torch.models import pendulum
from parallel_ddp_tpu_torch.mpc.controls import TrajHandoff, get_hardware_controls
from parallel_ddp_tpu_torch.mpc.driver import MPCConfig, MPCController
from parallel_ddp_tpu_torch.runtime import lcm_wire as lw
from parallel_ddp_tpu_torch.runtime import messages as msg
from parallel_ddp_tpu_torch.runtime import nodes
from parallel_ddp_tpu_torch.runtime.pubsub import Channels, NativeTrajRunner, PubSub

PORT = 7901


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _message_pairs():
    """(name, port message, JAX message): the same fields in both packages."""
    rng = np.random.default_rng(0)
    q, qd, tau = _rand(rng, 7), _rand(rng, 7), _rand(rng, 7)
    x, u, k = _rand(rng, 8, 14), _rand(rng, 8, 7), _rand(rng, 8, 7, 14)
    w = dict(q1=5.0, qf_ee1=123.0, r_ee=0.25, q_eev2=0.5, qf_xee=2.0)
    cases = [
        ("status", "Status", (1.25, q, qd, tau)),
        ("status_no_tau", "Status", (0.5, q, qd)),
        ("command", "Command", (2.5, tau, q)),
        ("command_no_ref", "Command", (2.5, tau)),
        ("trajectory", "Trajectory", (0.75, 0.01, x, u, k)),
        ("goal_pose", "Goal", (0, _rand(rng, 6))),
        ("goal_joint", "Goal", (1, _rand(rng, 14), _rand(rng, 14))),
        ("goal_twist", "Goal", (2, _rand(rng, 6))),
        ("solver_params", "SolverParams", (7, 50.0, True, 1)),
        ("command_hardware", "CommandHardware", (3.0, q, tau, _rand(rng, 6))),
        ("controller_reference", "ControllerReference", (4.0, q, qd, tau, _rand(rng, 7))),
    ]
    out = [(name, getattr(msg, cls)(*args), getattr(ref_msg, cls)(*args))
           for name, cls, args in cases]
    out.append(("cost_params", msg.CostParams(CostWeights(**w)),
                ref_msg.CostParams(RefCostWeights(**w))))
    return out


PAIRS = _message_pairs()


def _unpack(mod, buf, like):
    if isinstance(like, (msg.Trajectory, ref_msg.Trajectory)):
        n, nx = like.x.shape
        return mod.Trajectory.unpack(buf, nx=nx, nu=like.u.shape[1], dt=like.dt, n=n)
    return mod.unpack_any(buf)


def _same_fields(a, b):
    assert type(a).__name__ == type(b).__name__
    for name in a.__dataclass_fields__:
        va, vb = getattr(a, name), getattr(b, name)
        if name == "weights":
            assert tuple(va) == tuple(vb) and type(va)._fields == type(vb)._fields
        elif va is None or vb is None:
            assert va is None and vb is None, name
        else:
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb), err_msg=name)


@pytest.mark.parametrize("wire", ["native", "lcm"])
@pytest.mark.parametrize("name,port_m,ref_m", PAIRS, ids=[p[0] for p in PAIRS])
def test_messages_equal_bytes_and_cross_unpack(name, port_m, ref_m, wire):
    got, want = msg.pack_msg(port_m, wire), ref_msg.pack_msg(ref_m, wire)
    assert got == want
    if wire == "native":
        assert port_m.pack() == ref_m.pack()
    _same_fields(_unpack(msg, want, port_m), _unpack(ref_msg, want, ref_m))
    _same_fields(_unpack(ref_msg, got, ref_m), _unpack(msg, got, port_m))


@pytest.mark.parametrize("wire", ["native", "lcm"])
def test_trajectory_of_tensors_packs_from_one_host_copy(wire):
    _, port_m, ref_m = next(p for p in PAIRS if p[0] == "trajectory")
    as_tensors = msg.Trajectory(torch.tensor(port_m.t0), port_m.dt,
                                *(torch.as_tensor(a) for a in (port_m.x, port_m.u, port_m.K)))
    assert msg.pack_msg(as_tensors, wire) == ref_msg.pack_msg(ref_m, wire)
    t0, x, it = msg.to_host(torch.tensor(0.5), torch.ones(2, 3), torch.tensor(4, dtype=torch.int32))
    assert float(t0) == 0.5 and x.shape == (2, 3) and int(it) == 4


def test_lcm_wire_fingerprints_and_framing():
    assert set(lw.BY_FINGERPRINT) == set(ref_lw.BY_FINGERPRINT)
    for fp, st in lw.BY_FINGERPRINT.items():
        assert st.full_name == ref_lw.BY_FINGERPRINT[fp].full_name
    rng = np.random.default_rng(1)
    # one datagram up to 65,499 bytes with its 21-byte header, else LC03
    # fragments of 65,466 (the first, with the channel) and 65,479 bytes
    for size, n_frames in ((0, 1), (100, 1), (65_478, 1), (65_479, 2), (150_000, 3)):
        payload = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        for seq in (0, 7, 2**32 + 3):
            assert lw.frame_short(seq, "TRAJ_CHANNEL", payload) == ref_lw.frame_short(
                seq, "TRAJ_CHANNEL", payload)
            pkts = lw.frame_datagrams(seq, "TRAJ_CHANNEL", payload)
            assert pkts == ref_lw.frame_datagrams(seq, "TRAJ_CHANNEL", payload)
            assert len(pkts) == n_frames
            for parse, frames in ((lw.parse_datagram, pkts),
                                  (ref_lw.parse_datagram, pkts)):
                reasm, done = {}, []
                for p in frames:
                    got = parse(p, reasm)
                    if got is not None:
                        done.append(got)
                assert done == [("TRAJ_CHANNEL", payload)]


def _deliver(tx, rx, channel, payload, max_len=65000, timeout=3.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        tx.publish(channel, payload)
        time.sleep(0.01)
        got = rx.poll(channel, max_len=max_len)
        if got is not None:
            return got[0]
    return None


@pytest.mark.parametrize("wire", ["native", "lcm"])
def test_port_and_jax_buses_talk(wire):
    port_bus, ref_bus = PubSub(port=PORT, wire=wire), RefPubSub(port=PORT, wire=wire)
    try:
        port_bus.subscribe("FROM_JAX")
        ref_bus.subscribe("FROM_PORT")
        time.sleep(0.05)
        big = np.random.default_rng(2).integers(0, 256, 150_000 if wire == "lcm" else 60_000,
                                                dtype=np.uint8).tobytes()
        assert _deliver(port_bus, ref_bus, "FROM_PORT", big, max_len=200_000) == big
        assert _deliver(ref_bus, port_bus, "FROM_JAX", b"hello port") == b"hello port"
        status = msg.Status(1.0, np.ones(7, np.float32), np.zeros(7, np.float32))
        got = _deliver(port_bus, ref_bus, "FROM_PORT", msg.pack_msg(status, wire))
        np.testing.assert_array_equal(ref_msg.Status.unpack(got).q, status.q)
    finally:
        port_bus.close()
        ref_bus.close()


def test_native_traj_runner_matches_controls():
    rng = np.random.default_rng(0)
    n, nx, nu = 16, 4, 2
    x, u, k_arr = _rand(rng, n, nx), _rand(rng, n, nu), _rand(rng, n, nu, nx)
    tr = NativeTrajRunner(nx, nu)
    tr.set_traj(x, u, k_arr, t0=1.0, dt=0.1)
    traj = TrajHandoff(x, u, k_arr, 1.0, 0.1)
    cases = [(1.0, 0), (1.05, 0), (1.51, 0), (1.0 + 0.1 * (n - 2), 0),
             (1.0 + 0.1 * (n - 2) + 0.05, 0), (1.0 + 0.1 * (n - 1), 1), (0.95, 1), (2.55, 1)]
    for t, want_rc in cases:
        xm = _rand(rng, nx)
        for fb in (True, False):
            u_native, rc = tr.get_control(t, xm, fb)
            u_py, ok = get_hardware_controls(traj, t, xm, use_feedback=fb)
            assert rc == want_rc and (rc == 0) == ok, (t, rc)
            if ok:
                np.testing.assert_allclose(u_native, u_py, rtol=1e-5, atol=1e-6)
    _, rc = NativeTrajRunner(nx, nu).get_control(0.0, np.zeros(nx, np.float32))
    assert rc == 2
    with pytest.raises(ValueError):
        tr.set_traj(x, u, k_arr[:, :, :3], t0=1.0, dt=0.1)


@pytest.mark.parametrize("mode,value,x_target", [
    (0, [0.5, -0.4, 0.1, 0.3, 0.2, 0.1], None),
    (1, list(range(14)), None),
    (2, [0.5, -0.4, 0.1, 0.2, 0.0, -0.1], None),
    (2, [0.5, -0.4, 0.1, 0.2, 0.0, -0.1], list(range(14))),
    (0, [0.5, -0.4, 0.1, 0.0, 0.0, 0.0], list(range(14))),
])
def test_ee_goal_to_pytree_matches(mode, value, x_target):
    arr = lambda v: None if v is None else np.asarray(v, np.float32)
    got = nodes.ee_goal_to_pytree(msg.Goal(mode, arr(value), arr(x_target)))
    want = ref_nodes.ee_goal_to_pytree(ref_msg.Goal(mode, arr(value), arr(x_target)))
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


class RecordingBus:
    """Delivers scripted messages (a queue per channel; `stop` is set when
    they run out) and records what is published, in order."""

    def __init__(self, inbox=None, stop=None):
        self.inbox = {ch: list(ms) for ch, ms in (inbox or {}).items()}
        self.stop = stop
        self.wire = "native"
        self.sent = []

    def subscribe(self, channel):
        pass

    def publish(self, channel, payload):
        self.sent.append((channel, bytes(payload)))

    def poll_new(self, channel):
        queue = self.inbox.get(channel)
        if queue:
            return queue.pop(0), 0.0
        if self.stop is not None and not any(self.inbox.values()):
            self.stop.set()
        return None


def test_goal_pytree_keeps_its_structure_and_cost_shift():
    node = nodes.MPCLoopNode(None, RecordingBus(), nodes.ee_goal_to_pytree,
                             msg.Goal(msg.Goal.MODE_EE_TWIST, np.zeros(6, np.float32)),
                             device="cpu")
    g0 = node._goal_pytree()
    shift = g0["cost_shift"]
    assert isinstance(shift, torch.Tensor) and shift.dtype == torch.int32 and shift.dim() == 0
    assert int(shift) == 0
    sig = graphs.signature(g0)
    node.solver_params = msg.SolverParams(cost_shift=3)
    assert int(node._goal_pytree()["cost_shift"]) == 3
    assert graphs.signature(node._goal_pytree()) == sig
    node.solver_params = msg.SolverParams(cost_shift=0)
    assert graphs.signature(node._goal_pytree()) == sig
    # one conversion to tensors per Goal message
    assert node._goal_pytree()["ee_goal"] is g0["ee_goal"]
    node.goal = msg.Goal(msg.Goal.MODE_EE_TWIST, np.ones(6, np.float32))
    g1 = node._goal_pytree()
    assert g1["ee_goal"] is not g0["ee_goal"] and graphs.signature(g1) == sig
    normalized = nodes.normalize_goal_pytree({"ee_goal": np.zeros(6, np.float32)}, 2)
    assert normalized["cost_shift"] == 2 and normalized["cost_shift"].dtype == np.int32


def test_node_solves_make_no_capture_and_one_read():
    """Under `graphs.emulate()` (the card's graph route on CPU tensors): the
    node's warmup captures the cold start's solve and the MPC step; solves
    after a new goal, a new cost set, a shift toggle and new iteration and
    time limits replay them, and each reads the host once."""
    from parallel_ddp_tpu_torch.presets import kuka_ee

    prob = kuka_ee(num_time_steps=16, m_blocks=2, num_alpha=4)
    cfg = dataclasses.replace(prob.cfg, pallas_riccati=True, max_bp_retries=4)
    ctrl = MPCController(prob.plant, prob.cost, cfg, MPCConfig(max_iters_per_solve=2))
    cold = ctrl.init_state
    ctrl.init_state = lambda *a, **kw: cold(*a, warmup_iters=2, **kw)
    goal = msg.Goal(msg.Goal.MODE_EE_TWIST, np.asarray([0.5, 0.5, 0.1, 0, 0, 0], np.float32))
    node = nodes.MPCLoopNode(ctrl, RecordingBus(), nodes.ee_goal_to_pytree, goal, device="cpu")
    x0 = np.zeros(14, np.float32)
    with graphs.emulate():
        node.state = node.warmup(x0)
        assert node.captures() == 2
        status = msg.Status(0.01, x0[:7], x0[7:])
        changes = [
            lambda: setattr(node, "goal", msg.Goal(2, np.asarray([0.4, -0.5, 0.1, 0, 0, 0],
                                                                  np.float32))),
            lambda: setattr(node, "weights", CostWeights(q_ee1=75.0, qf_ee1=500.0)),
            lambda: setattr(node, "solver_params", msg.SolverParams(1, 10.0, False, 1)),
            lambda: setattr(node, "solver_params", msg.SolverParams(6, 0.5, False, 0)),
        ]
        trajs = []
        for k, change in enumerate(changes):
            change()
            trajs.append(node.solve(msg.Status(0.01 * (k + 1), x0[:7], x0[7:])))
        assert node.captures() == 2
    assert node.host_reads == node.solve_count == len(changes)
    assert [it for _, _, it in node.solve_trace][2] == 1     # iter_limit 1
    for t in trajs:
        assert t.x.shape == (16, 14) and t.K.shape == (16, 7, 14) and np.isfinite(t.x).all()
    assert trajs[0].t0 == pytest.approx(0.0) and trajs[-1].t0 > 0.0


def test_simulator_node_accepts_hardware_command():
    """SimulatorNode consumes both command flavours (Command and
    CommandHardware), and steps the plant as the JAX node does."""
    commands = [msg.CommandHardware(0.0, np.zeros(1, np.float32), np.asarray([0.7], np.float32)),
                msg.Command(0.01, np.asarray([0.3], np.float32))]
    x0 = np.asarray([0.4, -0.2], np.float32)
    port_node = nodes.SimulatorNode(pendulum(), RecordingBus(), x0, rate_hz=100.0,
                                    realtime=False, device="cpu")
    ref_node = ref_nodes.SimulatorNode(ref_pendulum(), RecordingBus(), x0, rate_hz=100.0,
                                       realtime=False)
    for node in (port_node, ref_node):
        node.tick()                                   # held until a command
        assert not node.commanded and np.array_equal(node.x, x0)
    for c in commands:
        for node in (port_node, ref_node):
            node.bus.inbox[Channels.COMMAND] = [c.pack()]
            node.tick()
        assert port_node.commanded and port_node.u[0] == pytest.approx(c.tau[0])
        np.testing.assert_allclose(port_node.x, ref_node.x, rtol=1e-6, atol=1e-6)
    assert port_node.step_count == 2 and len(port_node.bus.sent) == 3
    # a real bus: the command arrives over the multicast loopback
    pub, bus = PubSub(port=PORT + 2), PubSub(port=PORT + 2)
    try:
        node = nodes.SimulatorNode(pendulum(), bus, np.zeros(2, np.float32), rate_hz=100.0,
                                   realtime=False, device="cpu")
        time.sleep(0.05)
        pub.publish(Channels.COMMAND, commands[0].pack())
        time.sleep(0.05)
        node.tick()
        assert node.commanded and abs(node.u[0] - 0.7) < 1e-6
    finally:
        pub.close()
        bus.close()


def _run_until_stopped(node, stop, **kw):
    th = threading.Thread(target=node.run, args=(stop,), kwargs=kw, daemon=True)
    th.start()
    th.join(timeout=10.0)
    assert not th.is_alive()


def test_status_filter_node_publishes_the_same():
    rng = np.random.default_rng(3)
    stats = [msg.Status(0.01 * k + (0.005 if k == 3 else 0.0), _rand(rng, 7), _rand(rng, 7))
             for k in range(6)]
    stats.insert(4, stats[3])                  # a repeated stamp passes through
    sent = []
    for mod, alpha in ((nodes, 0.0), (ref_nodes, 0.0), (nodes, 0.6), (ref_nodes, 0.6)):
        stop = threading.Event()
        bus = RecordingBus({Channels.STATUS: [s.pack() for s in stats]}, stop)
        _run_until_stopped(mod.StatusFilterNode(bus, alpha=alpha), stop, poll_s=0.0)
        sent.append(bus.sent)
    assert sent[0] == sent[1] and sent[2] == sent[3] and sent[0] != sent[2]
    assert len(sent[0]) == len(stats)
    assert all(ch == Channels.STATUS_FILTERED for ch, _ in sent[0])


@pytest.mark.parametrize("torque_mode,hardware_mode", [(True, True), (False, False)])
def test_traj_playback_node_publishes_the_same(torque_mode, hardware_mode):
    T = 20
    q_traj = np.linspace(0, 1, T)[:, None] * np.ones((1, 7), np.float32)
    u_traj = np.full((T, 7), 2.5, np.float32)
    status = msg.Status(3.25, np.zeros(7, np.float32), np.zeros(7, np.float32)).pack()
    sent = []
    for mod in (nodes, ref_nodes):
        bus = RecordingBus({Channels.STATUS: [status]})
        node = mod.TrajPlaybackNode(bus, q_traj, u_traj, rate_hz=5000.0,
                                    torque_mode=torque_mode, hardware_mode=hardware_mode)
        _run_until_stopped(node, threading.Event())
        assert node.done and node.published == T
        sent.append(bus.sent)
    assert sent[0] == sent[1]
    first = msg.unpack_any(sent[0][0][1])
    assert isinstance(first, msg.CommandHardware if hardware_mode else msg.Command)
    assert first.utime == pytest.approx(3.25)


def test_snoop_decodes_the_channel():
    pub, bus = PubSub(port=PORT + 4), PubSub(port=PORT + 4)
    try:
        bus.subscribe(Channels.GOAL)
        time.sleep(0.05)
        goal = msg.Goal(2, np.arange(6, dtype=np.float32))
        th = threading.Thread(target=lambda: [(pub.publish(Channels.GOAL, goal.pack()),
                                               time.sleep(0.02)) for _ in range(10)])
        th.start()
        seen = nodes.snoop(bus, Channels.GOAL, duration=0.3)
        th.join(timeout=5.0)
        assert seen and isinstance(seen[0], msg.Goal)
        np.testing.assert_array_equal(seen[0].value, goal.value)
    finally:
        pub.close()
        bus.close()


def test_distributed_stack_pendulum():
    """Solver node + trajectory runner + simulator as separate threads talking
    only over the multicast bus, on CPU tensors, for 8 s: the pendulum must
    stay near upright (tests/test_runtime.py's stack, its assertions)."""
    cfg = SolverConfig(num_time_steps=32, total_time=1.0, m_blocks_b=2, m_blocks_f=2,
                       num_alpha=8, alpha_base=0.75, integrator=3, rho_init=10.0)
    ctrl = MPCController(pendulum(), pendulum_cost(32), cfg, MPCConfig(max_iters_per_solve=3))
    x0 = np.asarray([np.pi - 0.3, 0.0], np.float32)
    buses = [PubSub(port=PORT + 1) for _ in range(3)]
    node_solver = nodes.MPCLoopNode(
        ctrl, buses[0], goal_to_pytree=lambda g: g.value,
        initial_goal=msg.Goal(1, np.asarray([np.pi, 0.0], np.float32)), device="cpu")
    node_solver.warmup(x0)
    node_runner = nodes.TrajRunnerNode(2, 1, buses[1])
    node_sim = nodes.SimulatorNode(pendulum(), buses[2], x0, rate_hz=100.0, realtime=True,
                                   device="cpu")
    stop = threading.Event()
    threads = [threading.Thread(target=n.run, args=(stop,), daemon=True)
               for n in (node_solver, node_runner, node_sim)]
    for th in threads:
        th.start()
    try:
        time.sleep(8.0)
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=10.0)
        for b in buses:
            b.close()
    assert not any(th.is_alive() for th in threads)
    assert node_solver.solve_count > 3, "solver never closed the loop"
    assert node_runner.command_count > 10, "runner never produced commands"
    assert abs(float(node_sim.x[0]) - np.pi) < 0.35, f"pendulum drifted: {node_sim.x}"
    assert len(node_solver.solve_trace) == node_solver.solve_count
    assert all(ms > 0 and it >= 0 for _, ms, it in node_solver.solve_trace)
    assert node_solver.host_reads == node_solver.solve_count
    assert node_solver.captures() == 0
    assert len(node_runner.command_stamps) == node_runner.command_count
    assert (np.diff(np.asarray(node_runner.command_stamps)) >= 0).all()
