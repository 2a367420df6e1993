"""The RBD-Jacobian op and the AB composer (parallel_ddp_tpu_torch/ops/cuda_rbd.py)
against the reference, on the same seeded inputs.

  * `make_ab_composer` vs the reference's composer on the cheap nonlinear toy
    plant of tests/test_pallas_deriv.py, for all three integrators;
  * the Jacobian op's plain version vs eager `jax.vmap(jax.jacfwd(...))` of the
    reference's KukaSoA (eager: the jitted soa Jacobian takes minutes to
    compile on the CPU);
  * the hooked AB equals jacfwd of the port's own integrator step;
  * on a tensor that is not on the CPU the op never falls back to its plain
    version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_ddp_tpu.models.base import Plant as RefPlant
from parallel_ddp_tpu.models.kuka.soa import KukaSoA as RefSoA
from parallel_ddp_tpu.ops.integrators import make_step_jacobian as ref_step_jacobian
from parallel_ddp_tpu.ops.pallas_rbd import make_ab_composer as ref_composer
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


def test_no_fallback_off_cpu():
    """A tensor that is not on the CPU goes to the kernel path, which refuses
    what it cannot take — it never quietly runs the plain version."""
    x = torch.zeros((4, 14), device="meta")
    u = torch.zeros((4, 7), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_rbd.kuka_jac_qdd(x, u)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_rbd.kuka_jac_qdd_cuda(torch.zeros(4, 14), torch.zeros(4, 7))
    assert cuda_rbd.kuka_jac_qdd_cuda.launches == 0


def test_plant_hook_is_batched_and_generic():
    plant = Plant(name="p", n_pos=2, n_ctrl=2, dynamics=_toy_dyn(torch))
    jac = plant.qdd_jacobian()(torch.ones(4), torch.ones(2))
    assert jac.shape == (2, 6)
