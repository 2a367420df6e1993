"""The port's utilities (parallel_ddp_tpu_torch/utils/) against the JAX
package's.

  * checkpoints: an MPC state and a solve's solution saved by the JAX
    package load into the port bit for bit (values, dtypes, shapes), and the
    port's files load into the JAX package bit for bit; a warm start loaded
    from a file gives the same port solve, bit for bit, as the in-memory
    state it was saved from;
  * profiling: `timing_stats` and `AlgTrace.summary` equal the JAX ones on
    the same samples; `phase_times` on CPU tensors returns the JAX
    function's three phases with finite statistics."""

import dataclasses
import functools
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import torch

from parallel_ddp_tpu.mpc import driver as ref_driver
from parallel_ddp_tpu.utils import checkpoint as ref_ckpt
from parallel_ddp_tpu.utils import profiling as ref_prof
from parallel_ddp_tpu_torch import interop
from parallel_ddp_tpu_torch.config import SolverConfig
from parallel_ddp_tpu_torch.costs.joint import pendulum_cost
from parallel_ddp_tpu_torch.models import pendulum
from parallel_ddp_tpu_torch.mpc.driver import MPCState
from parallel_ddp_tpu_torch.presets import ee_goal, kuka_ee
from parallel_ddp_tpu_torch.solver import make_ilqr_solver
from parallel_ddp_tpu_torch.utils import checkpoint, profiling

N = 16


def _ref_state():
    rng = np.random.default_rng(0)
    f = lambda *shape: jnp.asarray(rng.normal(size=shape).astype(np.float32))
    return ref_driver.MPCState(x=f(N, 14), u=f(N, 7), K=f(N, 7, 14), P=f(N, 14, 14),
                               p=f(N, 14), d=f(N, 14), t0=jnp.float32(0.37),
                               fails=jnp.int32(3))


def _assert_bits(got, want, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, name
    np.testing.assert_array_equal(got, want, err_msg=name)


def test_mpc_state_files_load_across_packages(tmp_path):
    ref_st = _ref_state()
    ref_ckpt.save_mpc_state(str(tmp_path / "jax.npz"), ref_st)
    got = checkpoint.load_mpc_state(str(tmp_path / "jax.npz"), device="cpu")
    assert isinstance(got, MPCState)
    for name, a, b in zip(MPCState._fields, got, ref_st):
        assert a.device.type == "cpu"
        _assert_bits(a.numpy(), b, name)
    checkpoint.save_mpc_state(str(tmp_path / "port.npz"), interop.mpc_state(ref_st))
    back = ref_ckpt.load_mpc_state(str(tmp_path / "port.npz"))
    for name, a, b in zip(MPCState._fields, back, ref_st):
        _assert_bits(a, b, name)
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)


@functools.lru_cache(maxsize=None)
def _solve():
    """A 2-iteration port solve at kuka_ee(N = 16) and its goal and solver."""
    prob = kuka_ee(num_time_steps=N, m_blocks=2, num_alpha=4)
    cfg = dataclasses.replace(prob.cfg, max_iter=2, pallas_riccati=True)
    solver = make_ilqr_solver(prob.plant, prob.cost, cfg)
    goal = ee_goal([0.3, -0.3, 0.9], device="cpu")
    out = solver(torch.zeros(N, 14), torch.zeros(N, 7), goal, initial_rollout=True)
    return solver, goal, out


def test_solution_files_load_across_packages(tmp_path):
    _, _, out = _solve()
    checkpoint.save_solution(str(tmp_path / "port.npz"), out)
    want = {k: getattr(out, k).numpy() for k in ("x", "u", "K", "P", "p", "d")}
    jax_ws = ref_ckpt.load_warm_start(str(tmp_path / "port.npz"))
    for k, v in want.items():
        _assert_bits(jax_ws[k], v, k)
    with np.load(tmp_path / "port.npz") as f:
        _assert_bits(f["J_trace"], out.J_trace.numpy(), "J_trace")
        _assert_bits(f["alpha_trace"], out.alpha_trace.numpy(), "alpha_trace")
        _assert_bits(f["J"], out.J.numpy(), "J")
    # the JAX package writes the same file from the same arrays
    ref_out = type("Out", (), {k: jnp.asarray(getattr(out, k).numpy()) for k in
                               ("x", "u", "K", "P", "p", "d", "J", "J_trace", "alpha_trace")})
    ref_ckpt.save_solution(str(tmp_path / "jax.npz"), ref_out)
    ws = checkpoint.load_warm_start(str(tmp_path / "jax.npz"), device="cpu")
    assert sorted(ws) == sorted(want)
    for k, v in want.items():
        _assert_bits(ws[k].numpy(), v, k)


def test_load_warm_start_resumes_the_same_solve(tmp_path):
    solver, goal, out = _solve()
    checkpoint.save_solution(str(tmp_path / "sol.npz"), out)
    ws = checkpoint.load_warm_start(str(tmp_path / "sol.npz"), device="cpu")
    want = solver(out.x, out.u, goal, P0=out.P, p0=out.p, d0=out.d)
    got = solver(ws["x"], ws["u"], goal, P0=ws["P"], p0=ws["p"], d0=ws["d"])
    for name, a in got._asdict().items():
        if isinstance(a, torch.Tensor):
            torch.testing.assert_close(a, getattr(want, name), rtol=0, atol=0, equal_nan=True,
                                       msg=name)
    assert int(got.iters) == int(want.iters)


def test_timing_stats_match():
    samples = np.random.default_rng(4).exponential(0.003, 57)
    assert profiling.timing_stats(samples) == ref_prof.timing_stats(samples)
    assert profiling.timing_stats([0.002]) == ref_prof.timing_stats([0.002])


class _Out(NamedTuple):
    J: object
    iters: object
    alpha_trace: object


class _Info(NamedTuple):
    J: object
    iters: object
    accepted: object


def test_alg_trace_summary_matches():
    rng = np.random.default_rng(5)
    port, ref = profiling.AlgTrace(), ref_prof.AlgTrace()
    for k in range(7):
        j, it = np.float32(rng.exponential(50.0)), np.int32(rng.integers(1, 7))
        at = rng.integers(-1, 4, 7).astype(np.int32)
        if k == 3:
            at[:] = -1
        wall = float(rng.exponential(0.007))
        port.record_solve(_Out(torch.tensor(j), torch.tensor(it), torch.as_tensor(at)), wall)
        ref.record_solve(_Out(jnp.asarray(j), jnp.asarray(it), jnp.asarray(at)), wall)
        acc = bool(rng.integers(0, 2))
        port.record_mpc(_Info(torch.tensor(j), torch.tensor(it), torch.tensor(acc)), wall)
        ref.record_mpc(_Info(jnp.asarray(j), jnp.asarray(it), jnp.asarray(acc)), wall)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.summary() == ref.summary()
    assert set(port.summary()) == {"solve", "J_final_median", "iters_median", "accept_rate"}
    assert profiling.AlgTrace().summary() == ref_prof.AlgTrace().summary() == {}


def test_phase_times_on_the_cpu():
    cfg = SolverConfig(num_time_steps=32, total_time=1.0, m_blocks_b=2, m_blocks_f=2,
                       num_alpha=8, integrator=3, pallas_riccati=True)
    x = torch.zeros(32, 2)
    out = profiling.phase_times(pendulum(), pendulum_cost(32), cfg, x, torch.zeros(32, 1),
                                torch.tensor([np.pi, 0.0]), reps=3)
    assert set(out) == {"next_iter_setup", "backward_pass", "forward_pass"}
    for phase, stats in out.items():
        assert set(stats) == {"median_ms", "avg_ms", "std_ms", "min_ms", "max_ms"}, phase
        assert all(np.isfinite(v) and v >= 0 for v in stats.values()), phase
        assert stats["min_ms"] <= stats["median_ms"] <= stats["max_ms"]
