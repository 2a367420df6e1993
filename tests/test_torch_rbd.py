"""The RBD-Jacobian op and the AB composer (parallel_ddp_tpu_torch/ops/cuda_rbd.py)
against the reference, on the same seeded inputs.

  * `make_ab_composer` vs the reference's composer on the cheap nonlinear toy
    plant of tests/test_pallas_deriv.py, for all three integrators;
  * the Jacobian op's plain version vs eager `jax.vmap(jax.jacfwd(...))` of the
    reference's KukaSoA (eager: the jitted soa Jacobian takes minutes to
    compile on the CPU);
  * the hooked AB equals jacfwd of the port's own integrator step;
  * the forward-dynamics op's plain version vs the reference's Pallas qdd
    kernel (interpret mode) and soa core;
  * the Euler AB op's plain version equals the composer on the same Jacobian
    bit for bit and the reference's E + dt F; `make_kuka_ab` on CPU tensors is
    what it was before the kernel wrote the Euler AB itself;
  * on a tensor that is not on the CPU the ops never fall back to their plain
    versions."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_ddp_tpu.models.base import Plant as RefPlant
from parallel_ddp_tpu.models.kuka.soa import KukaSoA as RefSoA
from parallel_ddp_tpu.ops.integrators import make_step_jacobian as ref_step_jacobian
from parallel_ddp_tpu.ops.pallas_rbd import make_ab_composer as ref_composer
from parallel_ddp_tpu.ops.pallas_rbd import kuka_qdd_pallas
from parallel_ddp_tpu_torch.models.base import Plant
from parallel_ddp_tpu_torch.models.kuka import kuka, kuka_params
from parallel_ddp_tpu_torch.ops import cuda_rbd
from parallel_ddp_tpu_torch.ops.integrators import make_step_jacobian


def _toy_dyn(lib):
    def dynamics(x, u):
        q, qd = x[..., :2], x[..., 2:]
        return -3.0 * lib.sin(q) - 0.2 * qd * qd + (1.0 + 0.1 * lib.cos(q)) * u
    return dynamics


@pytest.mark.parametrize("integrator", [1, 2, 3])
def test_ab_composer_matches_reference(integrator):
    dt = 0.02
    rng = np.random.default_rng(integrator)
    x = rng.normal(0, 1.0, (16, 4)).astype(np.float32)
    u = rng.normal(0, 1.0, (16, 2)).astype(np.float32)

    jdyn = _toy_dyn(jnp)

    def jxdot(x, u):
        return jnp.concatenate([x[2:], jdyn(x, u)])

    def jjac(x, u):
        dx, du = jax.jacfwd(jxdot, argnums=(0, 1))(x, u)
        return jnp.concatenate([dx, du], axis=1)

    ref = ref_composer(jax.vmap(jxdot), jax.vmap(jjac), integrator, dt, ns=4, nj=2)(
        jnp.asarray(x), jnp.asarray(u))

    tdyn = _toy_dyn(torch)

    def txdot(x, u):
        return torch.cat([x[..., 2:], tdyn(x, u)], dim=-1)

    def tjac(x, u):
        dx, du = torch.func.vmap(torch.func.jacfwd(txdot, argnums=(0, 1)))(x, u)
        return torch.cat([dx, du], dim=-1)

    got = cuda_rbd.make_ab_composer(txdot, tjac, integrator, dt, ns=4, nj=2)(
        torch.as_tensor(x), torch.as_tensor(u))
    assert got.shape == (16, 4, 6)
    # same chain rule, float32, different matmul summation order
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)

    # and against the reference's AD oracle of the integrator step itself
    plant = RefPlant(name="toy2", n_pos=2, n_ctrl=2, dynamics=jdyn)
    oracle = jax.vmap(ref_step_jacobian(plant, integrator, dt))(jnp.asarray(x), jnp.asarray(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=1e-5, atol=1e-6)


def test_jacobian_plain_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 0.5, (8, 14)).astype(np.float32)
    u = rng.normal(0, 2.0, (8, 7)).astype(np.float32)
    ref = RefSoA(1, 0.0)
    jx, ju = jax.vmap(jax.jacfwd(ref.forward_dynamics, argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(u))
    ref_jac = np.concatenate([np.asarray(jx), np.asarray(ju)], axis=-1)
    ref_qdd = np.asarray(ref.forward_dynamics(jnp.asarray(x), jnp.asarray(u)))

    jac, qdd = cuda_rbd.kuka_jac_qdd(torch.as_tensor(x), torch.as_tensor(u), 1, 0.0)
    assert jac.shape == (8, 7, 21) and qdd.shape == (8, 7)
    # the same forward-mode chain; torch.func's and jax's jvp rules for sqrt
    # and division round differently: float32 ulps times cond(M) ~ 1e3
    scale = np.abs(ref_jac).max()
    np.testing.assert_allclose(jac.numpy(), ref_jac, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(qdd.numpy(), ref_qdd, rtol=0,
                               atol=2e-6 * np.abs(ref_qdd).max())


@pytest.mark.parametrize("integrator", [1, 3])
def test_hooked_ab_matches_step_jacobian(integrator):
    """The main path's AB (RBD-Jacobian op + composer) equals jacfwd of the
    port's own soa integrator step, vmapped over the batch."""
    dt = 0.5 / 63
    rng = np.random.default_rng(10 + integrator)
    x = torch.as_tensor(rng.normal(0, 0.5, (6, 14)).astype(np.float32))
    u = torch.as_tensor(rng.normal(0, 5.0, (6, 7)).astype(np.float32))
    hooked = kuka(kuka_params(mpc_mode=True, core="cuda"))
    plain = kuka(kuka_params(mpc_mode=True, core="soa"))
    assert plain.batched_step_jac is None and plain.fused_rollout is None
    got = hooked.batched_step_jac(integrator, dt)(x, u)
    ref = torch.func.vmap(make_step_jacobian(plain, integrator, dt))(x, u)
    assert got.shape == (6, 14, 21)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def _lifted_plain_jac(x, u, ee_type=1, gravity=0.0):
    """F = d [qd; qdd] / d [x; u] (B, 14, 21) from the op's plain Jacobian."""
    J, _ = cuda_rbd.kuka_jac_qdd_plain(x, u, ee_type, gravity)
    top = torch.zeros((J.shape[0], 7, 21))
    top[:, :, 7:14] = torch.eye(7)
    return torch.cat([top, J], dim=1)


def _seeded_xu(seed, batch=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.5, (batch, 14)).astype(np.float32),
            rng.normal(0, 2.0, (batch, 7)).astype(np.float32))


def test_euler_ab_plain_is_the_composer_bit_for_bit():
    """The plain version of the kernel's Euler output is `make_ab_composer`'s
    E + dt * F on the same J: no bit differs."""
    dt = 0.5 / 63
    x, u = (torch.as_tensor(a) for a in _seeded_xu(20))
    got = cuda_rbd.kuka_euler_ab(x, u, dt, 1, 0.0)
    ref = cuda_rbd.make_ab_composer(None, _lifted_plain_jac, 1, dt, 14, 7)(x, u)
    assert got.shape == (8, 14, 21) and got.dtype == torch.float32
    assert torch.equal(got, ref)
    assert torch.equal(cuda_rbd.kuka_euler_ab_plain(x, u, dt, 1, 0.0), ref)


def test_euler_ab_matches_reference():
    """Against the reference's Euler AB at B = 8: E + dt * F with F from
    jax.jacfwd of its soa dynamics (eager, as above), within 1e-5 of max |AB|
    (the Jacobians' forward-mode rounding, scaled by dt)."""
    dt = 0.5 / 63
    x, u = _seeded_xu(21)
    ref = RefSoA(1, 0.0)
    jx, ju = jax.vmap(jax.jacfwd(ref.forward_dynamics, argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(u))
    F = np.zeros((8, 14, 21), np.float32)
    F[:, :7, 7:14] = np.eye(7, dtype=np.float32)
    F[:, 7:, :] = np.concatenate([np.asarray(jx), np.asarray(ju)], axis=-1)
    E = np.concatenate([np.eye(14, dtype=np.float32), np.zeros((14, 7), np.float32)], axis=1)
    ref_ab = E + np.float32(dt) * F
    got = cuda_rbd.kuka_euler_ab(torch.as_tensor(x), torch.as_tensor(u), dt, 1, 0.0).numpy()
    np.testing.assert_allclose(got, ref_ab, rtol=0, atol=1e-5 * np.abs(ref_ab).max())


@pytest.mark.parametrize("integrator", [1, 2, 3])
def test_make_kuka_ab_unchanged_on_cpu(integrator):
    """On CPU tensors `make_kuka_ab` is bit for bit the chain it was when the
    composer built every integrator's AB from the Jacobian op."""
    dt = 0.5 / 63
    x, u = (torch.as_tensor(a) for a in _seeded_xu(30 + integrator, batch=5))

    def fboth(xs, us):
        _, qdd = cuda_rbd.kuka_jac_qdd(xs.contiguous(), us.contiguous(), 1, 0.0)
        return torch.cat([xs[:, 7:], qdd], dim=1), _lifted_plain_jac(xs, us)

    before = cuda_rbd.make_ab_composer(None, lambda xs, us: fboth(xs, us)[1], integrator, dt,
                                       14, 7, fboth=fboth)(x, u)
    got = cuda_rbd.make_kuka_ab(1, 0.0, integrator, dt)(x, u)
    assert torch.equal(got, before)


def test_no_fallback_off_cpu():
    """A tensor that is not on the CPU goes to the kernel path, which refuses
    what it cannot take — it never quietly runs the plain version."""
    x = torch.zeros((4, 14), device="meta")
    u = torch.zeros((4, 7), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_rbd.kuka_jac_qdd(x, u)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_rbd.kuka_jac_qdd_cuda(torch.zeros(4, 14), torch.zeros(4, 7))
    # the Euler AB goes the same way: the kernel path or an error
    with pytest.raises(ValueError, match="CUDA"):
        cuda_rbd.kuka_euler_ab(x, u, 0.01)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_rbd.make_kuka_ab(1, 0.0, 1, 0.01)(x, u)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_rbd.kuka_euler_ab_cuda(torch.zeros(4, 14), torch.zeros(4, 7), 0.01)
    assert cuda_rbd.kuka_jac_qdd_cuda.counter.launches == 0


def test_plant_hook_is_batched_and_generic():
    plant = Plant(name="p", n_pos=2, n_ctrl=2, dynamics=_toy_dyn(torch))
    jac = plant.qdd_jacobian()(torch.ones(4), torch.ones(2))
    assert jac.shape == (2, 6)


@functools.lru_cache(maxsize=None)
def _qdd_case(batch):
    """Seeded inputs, the reference's Pallas kernel (interpret mode) and its
    soa forward dynamics on them."""
    rng = np.random.default_rng(100 + batch)
    x = rng.normal(0, 0.5, (batch, 14)).astype(np.float32)
    u = rng.normal(0, 2.0, (batch, 7)).astype(np.float32)
    pallas = np.asarray(kuka_qdd_pallas(jnp.asarray(x), jnp.asarray(u), 1, 0.0, interpret=True))
    soa_ref = np.asarray(RefSoA(1, 0.0).forward_dynamics(jnp.asarray(x), jnp.asarray(u)))
    return x, u, pallas, soa_ref


@pytest.mark.parametrize("batch", [1, 37])
def test_qdd_plain_matches_reference(batch):
    """The forward-dynamics op (CPU: its plain version) against the
    reference's `kuka_qdd_pallas` and its soa core: the same chain in float32,
    ulps apart (times cond(M) ~ 1e3 through the Cholesky solve)."""
    x, u, pallas, soa_ref = _qdd_case(batch)
    got = cuda_rbd.kuka_qdd(torch.as_tensor(x), torch.as_tensor(u), 1, 0.0)
    assert got.shape == (batch, 7) and got.dtype == torch.float32
    for ref in (pallas, soa_ref):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-6 * np.abs(ref).max())
    # leading dims are flattened and restored; the Plant of the "cuda" core
    # runs this op
    plant = kuka(kuka_params(mpc_mode=True, core="cuda"))
    xs, us = torch.as_tensor(x).reshape(batch, 1, 14), torch.as_tensor(u).reshape(batch, 1, 7)
    torch.testing.assert_close(plant.dynamics(xs, us)[:, 0], got, rtol=0, atol=0)
    torch.testing.assert_close(plant.dynamics(xs[0, 0], us[0, 0]), got[0], rtol=0, atol=0)


def test_qdd_kernel_path_refuses():
    """Off the CPU the op goes to the kernel path, which refuses what it
    cannot take; under a torch.func transform or autograd the kernel path
    raises (it has no derivative rule) instead of falling back."""
    with pytest.raises(ValueError, match="CUDA"):
        cuda_rbd.kuka_qdd(torch.zeros((3, 14), device="meta"), torch.zeros((3, 7), device="meta"))
    with pytest.raises(RuntimeError, match="torch.func"):
        torch.func.vmap(cuda_rbd.kuka_qdd_cuda)(torch.zeros(2, 14), torch.zeros(2, 7))
    with pytest.raises(RuntimeError, match="backward"):
        cuda_rbd.kuka_qdd_cuda(torch.zeros(2, 14, requires_grad=True), torch.zeros(2, 7))
    with pytest.raises(ValueError, match="leading dims"):
        cuda_rbd.kuka_qdd_cuda(torch.zeros(2, 14), torch.zeros(3, 7))
    assert cuda_rbd.kuka_qdd_cuda.counter.launches == 0
