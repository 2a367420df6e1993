"""The port's EE cost family (parallel_ddp_tpu_torch/costs/ee.py), evaluated
over the time axis as a batch, against the reference's per-knot ee_cost on
the same seeded states: stage cost, gradient and Gauss-Newton Hessian.

Both sides use the scalar-channel Kuka kinematics; the only differences are
float32 summation order and the forward-mode rules, so the bound is a few
float32 ulps of each quantity's scale.  The EE Jacobian is the plant's
`ee_jac`: forward mode written out, equal to `torch.func.jacfwd` of ee_pose
bit for bit on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_ddp_tpu.config import CostWeights as RefWeights
from parallel_ddp_tpu.costs.ee import KUKA_POS_LIMITS, KUKA_TORQUE_LIMITS, KUKA_VEL_LIMITS
from parallel_ddp_tpu.costs.ee import ee_cost as ref_ee_cost
from parallel_ddp_tpu.models.kuka.soa import KukaSoA as RefSoA
from parallel_ddp_tpu_torch import interop
from parallel_ddp_tpu_torch.costs import ee
from parallel_ddp_tpu_torch.models.kuka import kuka, kuka_params
from parallel_ddp_tpu_torch.models.kuka.soa import KukaSoA

N = 8
OPTIONS = {
    "plain": {},
    "smooth_abs": dict(use_smooth_abs=True),
    "limits": dict(use_limits=True),
    "ee_vel": dict(use_ee_vel=True),
}


def _case(seed):
    rng = np.random.default_rng(seed)
    # joint positions/velocities large enough that some limits are active
    x = rng.normal(0, 1.2, (N, 14)).astype(np.float32)
    u = rng.normal(0, 150.0, (N, 7)).astype(np.float32)
    goal = {"ee_goal": jnp.asarray(rng.normal(0, 0.3, 6), jnp.float32),
            "x_target": jnp.asarray(rng.normal(0, 0.2, 14), jnp.float32)}
    w = RefWeights(q_ee2=0.3, qf_ee2=5.0, q_eev1=0.2, q_eev2=0.1, qf_eev1=3.0,
                   qf_eev2=1.0, q_xee=0.5, qf_xee=2.0)
    return x, u, goal, w


def _models(opts, cost_shift):
    kw = dict(pos_limits=KUKA_POS_LIMITS, vel_limits=KUKA_VEL_LIMITS,
              torque_limits=KUKA_TORQUE_LIMITS, final_cost_shift=cost_shift, **opts)
    ref = ref_ee_cost(RefSoA(1, 0.0).ee_pose, 7, 7, N, **kw)
    soa = KukaSoA(1, 0.0)
    port = ee.ee_cost(soa.ee_pose, soa.ee_pose_jacobian, 7, 7, N, **kw)
    return ref, port


def _close(got, ref, rel, name):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=rel, atol=rel * max(np.abs(ref).max(), 1.0),
                               err_msg=name)


@pytest.mark.parametrize("cost_shift", [0, 2])
@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_ee_cost_matches_reference(option, cost_shift):
    x, u, goal, w = _case(len(option) + cost_shift)
    ref, port = _models(OPTIONS[option], cost_shift)
    ks = jnp.arange(N)
    r_stage = jax.vmap(lambda xk, uk, k: ref.stage(xk, uk, k, goal, w))(x, u, ks)
    r_H, r_g = jax.vmap(lambda xk, uk, k: ref.quad(xk, uk, k, goal, w))(x, u, ks)

    tgoal, tw = interop.goal(goal), interop.cost_weights(w)
    tx, tu, tk = torch.as_tensor(x), torch.as_tensor(u), torch.arange(N)
    stage = port.stage(tx, tu, tk, tgoal, tw)
    H, g = port.quad(tx, tu, tk, tgoal, tw)
    assert stage.shape == (N,) and H.shape == (N, 21, 21) and g.shape == (N, 21)
    _close(stage, r_stage, 1e-5, "stage")
    _close(g, r_g, 1e-5, "gradient")
    _close(H, r_H, 1e-5, "hessian")
    # the Gauss-Newton Hessian is the unweighted J^T J: no EE weight in it
    q = tx[:, :7]
    jac = torch.func.vmap(torch.func.jacfwd(KukaSoA(1, 0.0).ee_pose))(q)
    if option != "ee_vel":
        jtj = (jac.mT @ jac)[:, :7, :7]
        torch.testing.assert_close(H[:, :7, :7] - torch.diag_embed(H.diagonal(dim1=1, dim2=2)[:, :7]),
                                   jtj - torch.diag_embed(jtj.diagonal(dim1=1, dim2=2)))


def test_live_cost_shift_and_batched_alphas():
    """A live `cost_shift` in the goal overrides the built-in one, and a
    (A, N) batch of trajectories equals A separate evaluations."""
    x, u, goal, w = _case(9)
    _, port = _models({}, 0)
    _, shifted = _models({}, 3)
    tgoal, tw = interop.goal(goal), interop.cost_weights(w)
    tx, tu, tk = torch.as_tensor(x), torch.as_tensor(u), torch.arange(N)
    live = dict(tgoal, cost_shift=torch.tensor(3))
    torch.testing.assert_close(port.stage(tx, tu, tk, live, tw),
                               shifted.stage(tx, tu, tk, tgoal, tw))
    xa = torch.stack([tx, tx * 0.5, tx + 0.1])
    ua = torch.stack([tu, tu * 0.5, tu - 1.0])
    batched = port.stage(xa, ua, tk, tgoal, tw)
    for a in range(3):
        torch.testing.assert_close(batched[a], port.stage(xa[a], ua[a], tk, tgoal, tw))


@pytest.mark.parametrize("ee_type", [0, 1, 2])
def test_ee_jacobian_matches_jax_jacfwd(ee_type):
    """The forward-mode `SerialArmSoA.ee_pose_jacobian` (the plant's `ee_jac`)
    against `jax.jacfwd` of the reference's ee_pose, for every EE type, on a
    seeded batch of q: float32 ulps of entries of order 1."""
    q = np.random.default_rng(20 + ee_type).normal(0, 1.2, (N, 7)).astype(np.float32)
    ref = np.asarray(jax.vmap(jax.jacfwd(RefSoA(ee_type, 0.0).ee_pose))(jnp.asarray(q)))
    plant = kuka(kuka_params(mpc_mode=True, ee_type=ee_type))
    got = plant.ee_jac(torch.as_tensor(q))
    assert got.shape == (N, 6, 7)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-6 * np.abs(ref).max())
    # batched over any leading dims
    torch.testing.assert_close(plant.ee_jac(torch.as_tensor(q).reshape(2, N // 2, 7)),
                               got.reshape(2, N // 2, 6, 7))


@pytest.mark.parametrize("ee_type", [0, 1, 2])
def test_ee_jacobian_equals_torch_jacfwd_bitwise(ee_type):
    """On the CPU the forward-mode `ee_jac` takes the same float32 steps as
    `torch.func.jacfwd` of the plant's ee_pose: equal bit for bit, at the
    solver's shapes (a (64,) time axis, an (A, N) alpha grid, one sample)."""
    plant = kuka(kuka_params(mpc_mode=True, ee_type=ee_type))
    rng = np.random.default_rng(40 + ee_type)
    for shape in [(64, 7), (4, 16, 7), (7,)]:
        q = torch.as_tensor(rng.uniform(-2.0, 2.0, shape).astype(np.float32))
        flat = q.reshape(-1, 7)
        want = torch.func.vmap(torch.func.jacfwd(plant.ee_pos))(flat)
        got = plant.ee_jac(q)
        assert got.shape == q.shape[:-1] + (6, 7)
        torch.testing.assert_close(got.reshape(-1, 6, 7), want, rtol=0, atol=0)


@pytest.mark.parametrize("option", ["plain", "smooth_abs", "limits"])
def test_quad_with_ee_jac_matches_reference_without_torch_func(option, monkeypatch):
    """With the plant's forward-mode Jacobian the cost quadratic equals the
    reference's (gradient and the unweighted J^T J Hessian) and calls no
    torch.func transform."""
    x, u, goal, w = _case(30 + len(option))
    ref, _ = _models(OPTIONS[option], 0)
    ks = jnp.arange(N)
    r_H, r_g = jax.vmap(lambda xk, uk, k: ref.quad(xk, uk, k, goal, w))(x, u, ks)
    soa = KukaSoA(1, 0.0)
    port = ee.ee_cost(soa.ee_pose, soa.ee_pose_jacobian, 7, 7, N,
                      pos_limits=KUKA_POS_LIMITS, vel_limits=KUKA_VEL_LIMITS,
                      torque_limits=KUKA_TORQUE_LIMITS, **OPTIONS[option])

    def refuse(*args, **kwargs):
        raise AssertionError("torch.func transform called")

    for name in ("jacfwd", "jacrev", "vmap", "jvp"):
        monkeypatch.setattr(torch.func, name, refuse)
    tx = torch.as_tensor(x)
    H, g = port.quad(tx, torch.as_tensor(u), torch.arange(N), interop.goal(goal),
                     interop.cost_weights(w))
    _close(g, r_g, 1e-5, "gradient")
    _close(H, r_H, 1e-5, "hessian")
    jac = soa.ee_pose_jacobian(tx[:, :7])
    jtj = jac.mT @ jac
    off = lambda a: a - torch.diag_embed(a.diagonal(dim1=-2, dim2=-1))
    torch.testing.assert_close(off(H[:, :7, :7]), off(jtj), rtol=0, atol=0)
