#!/usr/bin/env python3
"""Where the host time of the PyTorch / CUDA port's four-node stack goes on
one GPU: the stack of `chip_smoke.py`'s runtime phase (solver, runner,
simulator and pick-and-place goal node, each a thread of one process, on a
loopback bus) run for a few seconds in variants that each take one source of
contention for the interpreter lock away:

    python3 scripts/torch_runtime_contention.py [SECONDS] [REPEATS]

Variants (each REPEATS times, in turn; default 6 s, 2 repeats):
  * `full`: the phase's stack, the goal node's forward kinematics a
    CUDA-graph replay on a stream of its own (`chip_smoke.card_ee_pos`, as
    the JAX example hands its node `jax.jit(plant.ee_pos)`);
  * `fresh_poll`: the same with the bus allocating a zeroed 65,000-byte
    buffer for every poll (the JAX package's binding) instead of reusing one
    a thread;
  * `cpu_fk`: the goal node's forward kinematics as PyTorch ops on CPU
    tensors;
  * `no_fk`: the goal node reads the EE position off the first three joints
    (no kinematics: the floor of what its thread costs);
  * `no_goal`: no goal node;
  * `solver_only`: solver and simulator (the plant holds: no runner, no
    commands), the solver's host work without the others.

Each prints the solves, the node's solve ms (step + read, host clock), the
host time of `MPCController.step` and of the read apart, the simulator's
steps against the wall seconds and its tick ms, the runner's commands and
the goal node's kinematics calls and ms.  Prints the card line first.
"""

import ctypes
import dataclasses
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from parallel_ddp_tpu_torch.mpc.driver import MPCConfig, MPCController  # noqa: E402
from parallel_ddp_tpu_torch.ops import build  # noqa: E402
from parallel_ddp_tpu_torch.presets import kuka_ee  # noqa: E402
from parallel_ddp_tpu_torch.runtime import messages as msg  # noqa: E402
from parallel_ddp_tpu_torch.runtime import nodes, pubsub  # noqa: E402
from parallel_ddp_tpu_torch.tasks.pick_and_place import (PickAndPlaceConfig,  # noqa: E402
                                                         PickAndPlaceGoalNode, default_weights)

PORT = 7795


class _Fresh:
    """A 65,000-byte buffer made and zeroed for one poll, read as `raw`."""

    def __init__(self, buf):
        self.buf = buf

    def __getitem__(self, key):
        return self.buf.raw[key]


def fresh_poll(self, channel, max_len):
    buf = ctypes.create_string_buffer(max_len)
    t, seq = ctypes.c_double(), ctypes.c_uint64()
    n = self._lib.ps_poll(self._h, channel.encode(), buf, max_len, ctypes.byref(t),
                          ctypes.byref(seq))
    return n, _Fresh(buf), t.value, seq.value


def timed(obj, name, sink):
    """Wrap obj.name to append each call's host seconds to sink."""
    fn = getattr(obj, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        sink.append(time.perf_counter() - t0)
        return out

    setattr(obj, name, wrapper)


def stats(a):
    return (f"median {np.median(a) * 1e3:.3f} p99 {np.percentile(a, 99) * 1e3:.3f} ms"
            if len(a) else "none")


def variant(label, prob, cfg, dev, seconds, fk="graph", goal=True, runner=True):
    ctrl = MPCController(prob.plant, prob.cost, cfg, MPCConfig(max_iters_per_solve=cs.N_ITERS))
    x_init = cs.pp_x_init(np)
    ee_pos = {"cpu": lambda q: prob.plant.ee_pos(torch.as_tensor(q))[:3].numpy(),
              "graph": cs.card_ee_pos(torch, prob.plant, dev) if fk == "graph" else None,
              "none": lambda q: np.asarray(q[:3], np.float32)}[fk]
    buses = [pubsub.PubSub(port=PORT) for _ in range(4)]
    goal_node = PickAndPlaceGoalNode(buses[3], ee_pos, PickAndPlaceConfig(),
                                     rng=np.random.default_rng(0))
    goal0 = msg.Goal(msg.Goal.MODE_EE_TWIST,
                     np.concatenate([goal_node.goal, np.zeros(3)]).astype(np.float32))
    solver = nodes.MPCLoopNode(ctrl, buses[0], nodes.ee_goal_to_pytree, goal0,
                               weights=default_weights(), device=dev)
    solver.warmup(x_init)
    run_node = nodes.TrajRunnerNode(14, 7, buses[1])
    sim = nodes.SimulatorNode(prob.plant, buses[2], x_init, rate_hz=cs.PP_SIM_HZ, integrator=1,
                              realtime=True, device=dev)
    t_step, t_read, t_tick, t_fk = [], [], [], []
    timed(ctrl, "step", t_step)
    timed(sim, "_step", t_tick)
    timed(goal_node, "_ev_norm", t_fk)
    to_host = msg.to_host
    timed(msg, "to_host", t_read)
    torch.cuda.synchronize()
    stop = threading.Event()
    live = [solver, sim] + ([run_node] if runner else []) + ([goal_node] if goal else [])
    threads = [threading.Thread(target=n.run, args=(stop,), daemon=True) for n in live]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    time.sleep(seconds)
    stop.set()
    for th in threads:
        th.join(timeout=10.0)
    wall = time.perf_counter() - t0
    msg.to_host = to_host
    for b in buses:
        b.close()
    solve_s = np.asarray([ms for _, ms, _ in solver.solve_trace]) * 1e-3
    print(f"{label}: {solver.solve_count} solves, solve {stats(solve_s)}; step host "
          f"{stats(t_step[2:])}; read {stats(t_read)}; simulator {sim.step_count} steps in "
          f"{wall:.2f} s ({sim.step_count / wall:.0f} a second), tick {stats(t_tick)}; runner "
          f"{run_node.command_count} commands; kinematics {len(t_fk)} calls, {stats(t_fk)}",
          flush=True)


def main():
    seconds = float(sys.argv[1]) if len(sys.argv) > 1 else 6.0
    repeats = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    build.build()
    build.library()
    from parallel_ddp_tpu_torch.ops import cuda_rbd, cuda_riccati, cuda_rollout, cuda_sim_chain  # noqa: F401
    build.prepare_counters(dev)
    print(cs.card_line(), flush=True)
    prob = kuka_ee(mpc_mode=True)
    cfg = dataclasses.replace(prob.cfg, pallas_riccati=True)
    reuse = pubsub.PubSub._poll
    for rep in range(repeats):
        variant(f"full ({rep})", prob, cfg, dev, seconds)
        pubsub.PubSub._poll = fresh_poll
        variant(f"fresh_poll ({rep})", prob, cfg, dev, seconds)
        pubsub.PubSub._poll = reuse
        variant(f"cpu_fk ({rep})", prob, cfg, dev, seconds, fk="cpu")
        variant(f"no_fk ({rep})", prob, cfg, dev, seconds, fk="none")
        variant(f"no_goal ({rep})", prob, cfg, dev, seconds, goal=False)
        variant(f"solver_only ({rep})", prob, cfg, dev, seconds, goal=False, runner=False)


if __name__ == "__main__":
    main()
