"""The port's exact log-depth backward pass (`bp_assoc_scan`) and its scan
(parallel_ddp_tpu_torch/parallel/scan.py), on the CPU.

  * `associative_scan` against `jax.lax.associative_scan`, bit for bit:
    under a + b on float32 values spread over 1e-8..1e8 (only the same
    pairing gives the same bits: a sequential sum differs from length 63
    on), and under the non-commutative (a0 b0, a1 b0 + b1), which also pins
    the order of fn's arguments; lengths 1, 2, 3, 63, 64 and 255, both
    directions, a leading dim of 3.  The products of the second case stay
    near 1: XLA's CPU kernels flush float32 subnormals to zero and torch's
    do not, so an underflowing product would differ for that reason alone;
  * the backward pass against the reference package's `backward_pass` with
    `bp_assoc_scan=True`: on tests/test_assoc_bp.py's random LQR data
    (N = 32, n = 4, m = 2, m_blocks_f 1 and 4) at that test's tolerances,
    and at the Kuka's (14, 7), N = 64, on the port's derivative stage at the
    WAFR cold start (the reference's `soa` core takes minutes to compile on
    a CPU, so both packages take the port's AB / H / g / d as numpy arrays);
    both against the port's own serial pass at m_blocks_b = 1;
  * a rho retry (an indefinite R fails the first attempt): fail, rho and
    drho equal the reference's;
  * a batch of 3 scenarios equals its three single passes bit for bit (as
    tests/test_torch_batched.py holds the block path);
  * the pendulum solve of tests/test_assoc_bp.py:70 against the reference's:
    the same alphas, J within rtol 1e-4;
  * the solve's graph route under `graphs.emulate()`: no host read, one
    capture for new goals and weights, the host route bit for bit; the
    batched solver and the MPC step take the option through the same body.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_ddp_tpu.config import SolverConfig as RefConfig
from parallel_ddp_tpu.parallel.backward import backward_pass as ref_backward_pass
from parallel_ddp_tpu.presets import pendulum_swingup as ref_pendulum_swingup
from parallel_ddp_tpu.solver import make_ilqr_solver as ref_make_ilqr_solver
from parallel_ddp_tpu_torch import graphs, interop
from parallel_ddp_tpu_torch.config import CostWeights, SolverConfig, weights_tensor
from parallel_ddp_tpu_torch.mpc import driver
from parallel_ddp_tpu_torch.parallel.backward import backward_pass
from parallel_ddp_tpu_torch.parallel.scan import associative_scan
from parallel_ddp_tpu_torch.parallel.sharding import make_batched_solver
from parallel_ddp_tpu_torch.presets import ee_goal, kuka_ee, pendulum_swingup
from parallel_ddp_tpu_torch.solver import _derivatives, make_ilqr_solver, open_loop_rollout

LENGTHS = (1, 2, 3, 63, 64, 255)
FIELDS = ("P", "p", "K", "du", "ApBK", "Bdu")
# tests/test_assoc_bp.py's tolerances (rtol, atol) on its random LQR data
LQR_TOL = {"P": (2e-4, 2e-4), "p": (2e-4, 2e-3), "K": (2e-4, 2e-4), "du": (2e-4, 2e-3),
           "ApBK": (2e-4, 2e-4), "Bdu": (2e-4, 2e-3)}
LQR_DJ_RTOL = 1e-3
# the Kuka's pass: |a - b| <= KUKA_RTOL |b| + KUKA_ATOL max|b|.  P reaches 1e3
# and Huu's condition number ~1e3 amplifies float32 rounding; the two
# packages' matrix products and LU solves round in another order (measured:
# at most 2.3e-5 of max|b|, in Bdu)
KUKA_RTOL, KUKA_ATOL = 1e-3, 1e-4
# the pendulum solve: tests/test_assoc_bp.py's bars
SOLVE_J_RTOL = 1e-4
SOLVE_X_TOL = 1e-3


def _bits(a):
    return np.asarray(a).view(np.int32)


def _same(a, b, name=""):
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True, msg=name)


def _port_scan(fn, elems, reverse):
    return associative_scan(fn, tuple(torch.from_numpy(e) for e in elems), dim=1,
                            reverse=reverse)


def _ref_scan(fn, elems, reverse):
    return jax.lax.associative_scan(fn, tuple(jnp.asarray(e) for e in elems), reverse=reverse,
                                    axis=1)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("length", LENGTHS)
def test_scan_of_a_sum_equals_jax_bit_for_bit(length, reverse):
    rng = np.random.default_rng(length)
    x = (10.0 ** rng.uniform(-8, 8, (3, length)) * rng.choice([-1.0, 1.0], (3, length)))
    x = x.astype(np.float32)
    add = lambda a, b: (a[0] + b[0],)
    got = _port_scan(add, (x,), reverse)[0].numpy()
    want = np.asarray(_ref_scan(add, (x,), reverse)[0])
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if length >= 63:     # the data tells the pairings apart
        seq = np.cumsum(x[:, ::-1] if reverse else x, axis=1, dtype=np.float32)
        assert not np.array_equal(_bits(seq[:, ::-1] if reverse else seq), _bits(want))


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("length", LENGTHS)
def test_scan_of_an_affine_map_equals_jax_bit_for_bit(length, reverse):
    rng = np.random.default_rng(100 + length)
    a0 = np.exp(rng.uniform(-0.05, 0.05, (3, length))).astype(np.float32)
    a1 = rng.normal(0, 1, (3, length)).astype(np.float32)
    fn = lambda a, b: (a[0] * b[0], a[1] * b[0] + b[1])
    got = _port_scan(fn, (a0, a1), reverse)
    want = _ref_scan(fn, (a0, a1), reverse)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
    if length >= 2:      # fn's arguments swapped give other numbers
        swapped = _port_scan(lambda a, b: fn(b, a), (a0, a1), reverse)
        assert not np.array_equal(_bits(swapped[1].numpy()), _bits(want[1]))


def test_scan_over_tensors_of_different_ranks():
    """A scale per element (3, T) beside a vector per element (3, T, 2), the
    time axis at dim 1 of both (a negative dim names it from the first
    tensor's end, as JAX's axis)."""
    rng = np.random.default_rng(5)
    s = np.exp(rng.uniform(-0.05, 0.05, (3, 64))).astype(np.float32)
    v = rng.normal(0, 1, (3, 64, 2)).astype(np.float32)
    fn = lambda a, b: (a[0] * b[0], a[1] * b[0][..., None] + b[1])
    want = jax.lax.associative_scan(fn, (jnp.asarray(s), jnp.asarray(v)), reverse=True, axis=1)
    got = associative_scan(fn, (torch.from_numpy(s), torch.from_numpy(v)), dim=-1,
                           reverse=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
    with pytest.raises(ValueError, match="lengths"):
        associative_scan(fn, (torch.zeros(3, 4), torch.zeros(3, 5, 2)), dim=1)


# --- the backward pass -------------------------------------------------------

def _random_lqr_data(rng, N, n, m, m_blocks_f=1):
    """tests/test_assoc_bp.py's data, as numpy."""
    AB = rng.normal(0, 0.4, (N - 1, n, n + m)).astype(np.float32)
    Hs = []
    for _ in range(N):
        a = rng.normal(0, 0.4, (n + m, n + m))
        Hs.append(a @ a.T + 0.5 * np.eye(n + m))
    H = np.stack(Hs).astype(np.float32)
    g = rng.normal(0, 1.0, (N, n + m)).astype(np.float32)
    d = np.zeros((N, n), np.float32)
    if m_blocks_f > 1:
        nf_blk = N // m_blocks_f
        bidx = (np.arange(m_blocks_f - 1) + 1) * nf_blk - 1
        d[bidx] = rng.normal(0, 0.1, (len(bidx), n)).astype(np.float32)
    return AB, H, g, d


def _both_passes(cfg_kw, AB, H, g, d, rho=1.0, Pp=None, pp=None, x=None, xp2=None):
    """(reference assoc, port assoc, port serial at m_blocks_b = 1) on one
    set of numpy arrays; rho0 = rho, drho0 = 1."""
    N, n = d.shape
    zeros = lambda *s: np.zeros(s, np.float32)
    rest = [zeros(N, n, n) if Pp is None else Pp, zeros(N, n) if pp is None else pp, d,
            zeros(N, n) if x is None else x, zeros(N, n) if xp2 is None else xp2]
    args = [AB, H, g] + rest
    kw = dict(cfg_kw, m_blocks_b=1, state_reg=False, pallas_riccati=False)
    assoc = dict(kw, bp_assoc_scan=True)
    ref = ref_backward_pass(RefConfig(**assoc), *(jnp.asarray(a) for a in args),
                            jnp.asarray(rho, jnp.float32), jnp.asarray(1.0, jnp.float32))
    t = [torch.as_tensor(a) for a in args]
    rho_t, drho_t = torch.tensor(rho, dtype=torch.float32), torch.tensor(1.0)
    port = backward_pass(SolverConfig(**assoc), *t, rho_t, drho_t)
    serial = backward_pass(SolverConfig(**dict(kw, bp_assoc_scan=False)), *t, rho_t, drho_t)
    return ref, port, serial


@pytest.mark.parametrize("m_blocks_f", [1, 4])
def test_assoc_backward_matches_reference_on_lqr_data(m_blocks_f):
    N, n, m = 32, 4, 2
    AB, H, g, d = _random_lqr_data(np.random.default_rng(7), N, n, m, m_blocks_f)
    ref, port, serial = _both_passes(dict(num_time_steps=N, total_time=1.0,
                                          m_blocks_f=m_blocks_f, num_alpha=4), AB, H, g, d)
    assert not bool(ref.fail) and not bool(port.fail) and not bool(serial.fail)
    for want in (ref, serial):
        for name in FIELDS:
            rtol, atol = LQR_TOL[name]
            np.testing.assert_allclose(getattr(port, name).numpy(), np.asarray(getattr(want, name)),
                                       rtol=rtol, atol=atol, err_msg=name)
        np.testing.assert_allclose(port.dJexp.numpy(), np.asarray(want.dJexp), rtol=LQR_DJ_RTOL)
    assert float(port.rho) == float(ref.rho) and float(port.drho) == float(ref.drho)
    assert port.host_syncs == 1


@functools.lru_cache(maxsize=None)
def _kuka_cold_start_data():
    """The port's derivative stage at the WAFR cold start (kuka_ee(): N = 64,
    4 + 4 blocks, Euler): the goldens' seeded state at every knot, zero
    torques, rolled out block by block, toward (0, -0.55, 0.35)."""
    prob = kuka_ee()
    cfg = dataclasses.replace(prob.cfg, pallas_riccati=False, state_reg=False)
    solver = make_ilqr_solver(prob.plant, prob.cost, cfg)
    N = cfg.num_time_steps
    x_start = (np.random.default_rng(0).standard_normal(14) * 0.3).astype(np.float32)
    x0 = torch.as_tensor(np.broadcast_to(x_start, (N, 14)).copy())
    u0 = torch.zeros(N, 7)
    goal = ee_goal([0.0, -0.55, 0.35], device="cpu")
    x, d = open_loop_rollout(cfg, solver.chain.open_loop, x0, u0)
    w = weights_tensor(None, torch.device("cpu"), torch.float32)
    AB, H, g = _derivatives(cfg, solver.step_jac, prob.cost.quad, x, u0, goal, w)
    cfg_kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return cfg_kw, [t.numpy() for t in (AB, H, g, d, x)]


def test_assoc_backward_matches_reference_at_the_kuka_width():
    cfg_kw, (AB, H, g, d, x) = _kuka_cold_start_data()
    assert AB.shape == (63, 14, 21) and float(np.abs(d).max()) > 0   # defects on boundaries
    ref, port, serial = _both_passes(cfg_kw, AB, H, g, d, rho=cfg_kw["rho_init"], x=x, xp2=x)
    assert not bool(ref.fail) and not bool(port.fail) and not bool(serial.fail)
    for want in (ref, serial):
        for name in FIELDS + ("dJexp",):
            b = np.asarray(getattr(want, name)).astype(np.float64)
            a = getattr(port, name).numpy().astype(np.float64)
            np.testing.assert_allclose(a, b, rtol=KUKA_RTOL, atol=KUKA_ATOL * np.abs(b).max(),
                                       err_msg=name)


def _indefinite_lqr_data(seed, indefinite):
    """Random LQR data (n = 3, m = 2, N = 16, 2 shooting blocks) whose R is
    indefinite with `indefinite`: the pass retries rho."""
    rng = np.random.default_rng(seed)
    N, n, m = 16, 3, 2
    AB, H, g, d = _random_lqr_data(rng, N, n, m, 2)
    if indefinite:
        H[:, n:, n:] -= 3.0 * np.eye(m, dtype=np.float32)
    return AB, H, g, d


def test_assoc_rho_retry_matches_reference():
    AB, H, g, d = _indefinite_lqr_data(0, True)
    cfg_kw = dict(num_time_steps=16, total_time=0.5, m_blocks_f=2, num_alpha=4)
    ref, port, serial = _both_passes(cfg_kw, AB, H, g, d, rho=0.1)
    assert float(ref.rho) > 0.1 and not bool(ref.fail)
    assert bool(port.fail) == bool(ref.fail)
    assert float(port.rho) == float(ref.rho) and float(port.drho) == float(ref.drho)
    assert port.host_syncs > 2               # the first attempt and at least one retry
    for name in FIELDS:
        rtol, atol = LQR_TOL[name]
        np.testing.assert_allclose(getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=rtol, atol=atol, err_msg=name)


def test_batched_assoc_backward_equals_single_passes():
    """Three scenarios, the middle one retrying rho: the batch's pass is
    each single pass bit for bit, rho, drho and fail included."""
    scen = [_indefinite_lqr_data(s, s == 1) for s in range(3)]
    N, n = scen[0][3].shape
    cfg = SolverConfig(num_time_steps=N, total_time=0.5, m_blocks_f=2, num_alpha=4,
                       state_reg=False, bp_assoc_scan=True)
    zeros = lambda *s: torch.zeros(s)

    def args(AB, H, g, d):
        return [torch.as_tensor(a) for a in (AB, H, g)] + [
            zeros(N, n, n), zeros(N, n), torch.as_tensor(d), zeros(N, n), zeros(N, n)]

    rho0, drho0 = torch.full((3,), 0.1), torch.ones(3)
    batched = backward_pass(cfg, *(torch.stack(t) for t in zip(*(args(*s) for s in scen))),
                            rho0, drho0)
    singles = [backward_pass(cfg, *args(*s), rho0[b], drho0[b]) for b, s in enumerate(scen)]
    assert float(singles[1].rho) > 0.1
    assert torch.equal(singles[0].rho, rho0[0]) and torch.equal(singles[2].rho, rho0[2])
    for b, one in enumerate(singles):
        for name, a in one._asdict().items():
            if isinstance(a, torch.Tensor):
                _same(getattr(batched, name)[b], a, f"scenario {b} {name}")
    assert batched.host_syncs == singles[1].host_syncs


# --- solves ------------------------------------------------------------------

def test_assoc_pendulum_solve_matches_reference():
    """tests/test_assoc_bp.py:70's solve through both packages."""
    ref_prob = ref_pendulum_swingup(num_time_steps=64, m_blocks=1, num_alpha=8)
    ref_cfg = dataclasses.replace(ref_prob.cfg, state_reg=False, max_iter=10, m_blocks_f=4,
                                  m_blocks_b=1, bp_assoc_scan=True)
    ref = ref_make_ilqr_solver(ref_prob.plant, ref_prob.cost, ref_cfg)(
        jnp.zeros((64, 2), jnp.float32), jnp.zeros((64, 1), jnp.float32),
        jnp.asarray([np.pi, 0.0]), initial_rollout=True)
    prob = pendulum_swingup(num_time_steps=64, m_blocks=1, num_alpha=8)
    cfg = interop.solver_config(ref_cfg)
    assert cfg.bp_assoc_scan and not cfg.pallas_riccati
    out = make_ilqr_solver(prob.plant, prob.cost, cfg)(
        torch.zeros(64, 2), torch.zeros(64, 1), torch.tensor([np.pi, 0.0]), initial_rollout=True)
    np.testing.assert_array_equal(out.alpha_trace.numpy(), np.asarray(ref.alpha_trace))
    np.testing.assert_allclose(float(out.J), float(ref.J), rtol=SOLVE_J_RTOL)
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), rtol=SOLVE_X_TOL,
                               atol=SOLVE_X_TOL)


N_SMALL, M_SMALL, A_SMALL = 16, 2, 4
GOALS = ((0.3, -0.3, 0.9), (0.35, -0.25, 0.85))


def _small_assoc_problem(max_iter=3):
    prob = kuka_ee(num_time_steps=N_SMALL, m_blocks=M_SMALL, num_alpha=A_SMALL)
    cfg = dataclasses.replace(prob.cfg, max_iter=max_iter, tol_cost=0.0, pallas_riccati=False,
                              state_reg=False, bp_assoc_scan=True, max_bp_retries=4)
    return prob, cfg


def test_assoc_solve_graph_route_makes_no_host_read():
    """The assoc solve's graph route under `graphs.emulate()`: the host
    route bit for bit, 0 host reads, and one capture for new goals and
    weights."""
    prob, cfg = _small_assoc_problem()
    solver = make_ilqr_solver(prob.plant, prob.cost, cfg)
    x0, u0 = torch.zeros(N_SMALL, 14), torch.zeros(N_SMALL, 7)
    goals = [ee_goal(g, device="cpu") for g in GOALS]
    w2 = CostWeights(r_ee=1e-3)
    cases = ((goals[0], None), (goals[1], None), (goals[0], w2))
    want = [solver(x0, u0, g, w, initial_rollout=True) for g, w in cases]
    assert solver.host_syncs > 0
    with graphs.emulate():
        got = []
        for g, w in cases:
            got.append(solver(x0, u0, g, w, initial_rollout=True))
            assert solver.host_syncs == 0
        assert len(solver.graphs) == 1
    for a, b in zip(got, want):
        for name, t in a._asdict().items():
            if isinstance(t, torch.Tensor):
                _same(t, getattr(b, name), name)
    assert float(want[0].J) < float(want[0].J_trace[0])
    assert not torch.equal(got[2].J_trace, got[0].J_trace)


def test_assoc_batched_solve_and_mpc_step():
    """make_batched_solver takes the option: B = 2 equals the single solves
    bit for bit; an MPC cold start and step run it too, and the step's graph
    route equals its host route."""
    prob, cfg = _small_assoc_problem()
    goals = [ee_goal(g, device="cpu") for g in GOALS]
    x0, u0 = torch.zeros(N_SMALL, 14), torch.zeros(N_SMALL, 7)
    batched = make_batched_solver(prob.plant, prob.cost, cfg)(
        torch.stack([x0, x0]), torch.stack([u0, u0]),
        {k: torch.stack([g[k] for g in goals]) for k in goals[0]})
    single = make_ilqr_solver(prob.plant, prob.cost, cfg)
    for b, goal in enumerate(goals):
        one = single(x0, u0, goal, initial_rollout=True)
        for name, t in one._asdict().items():
            if isinstance(t, torch.Tensor):
                _same(getattr(batched, name)[b], t, f"scenario {b} {name}")

    ctrl = driver.MPCController(prob.plant, prob.cost, cfg, driver.MPCConfig(max_iters_per_solve=2))
    x_init = np.zeros(14, np.float32)
    x_init[1], x_init[3], x_init[5] = np.pi / 4, -np.pi / 4, np.pi / 4
    st = ctrl.init_state(torch.as_tensor(x_init), goal=goals[0], warmup_iters=3)
    assert torch.isfinite(st.x).all() and torch.isfinite(st.K).all()
    xs = torch.as_tensor(x_init)
    host = ctrl.step(st, xs, 0.01, goals[1])
    assert ctrl.host_syncs > 0
    with graphs.emulate():
        got = ctrl.step(st, xs, 0.01, goals[1])
        assert ctrl.host_syncs == 0
    for a, b in zip(got[0] + got[1], host[0] + host[1]):
        _same(a, b)
    assert torch.isfinite(host[0].x).all()


def test_assoc_al_inner_solve():
    """The AL inner solve takes the option too: a pendulum solve under
    |u| <= 3 (tests/test_torch_constraints.py's case) with the exact pass,
    its graph route the host route bit for bit with no host read in the
    inner replays, and the bound nearly met."""
    from parallel_ddp_tpu_torch import constraints

    N = 16
    prob = pendulum_swingup(num_time_steps=N, total_time=1.0, m_blocks=2, num_alpha=4)
    cfg = dataclasses.replace(prob.cfg, max_iter=4, state_reg=False, bp_assoc_scan=True)
    con = constraints.BoxConstraints(n_state=2, n_ctrl=1, u_min=[-3.0], u_max=[3.0])
    al = constraints.make_al_solver(prob.plant, prob.cost, cfg, con,
                                    constraints.ALConfig(max_outer=3))
    x0, u0, goal = torch.zeros(N, 2), torch.zeros(N, 1), torch.tensor([np.pi, 0.0])
    host, host_info = al(x0, u0, goal)
    with graphs.emulate():
        got, info = al(x0, u0, goal)
        assert al.solver.host_syncs == 0
    assert info["outer_iters"] == host_info["outer_iters"] >= 2
    for name, t in got._asdict().items():
        if isinstance(t, torch.Tensor):
            _same(t, getattr(host, name), name)
    assert float(got.u[:-1].abs().max()) < 3.0 * 1.1
