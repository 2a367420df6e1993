"""The port's spatial-algebra core (parallel_ddp_tpu_torch/models/kuka/rbd.py)
against the JAX package's KukaRBD, and against the port's own scalar-channel
core, on the same seeded inputs (CPU).

The two spatial-algebra cores run the same algorithms (RNEA, CRBA, Cholesky)
in another arrangement (6x6 spatial transforms here, 3-vectors joint by joint
there), so they agree to float32 rounding of two summation orders, amplified
for qdd by the mass matrix's condition number (~1e3): held to 1e-5 of the
largest value (measured 4e-7), the step Jacobian AB to 1e-4 (the jacfwd of
~500 operations).  Against the port's scalar-channel core, on the Kuka and on
generic URDF chains with prismatic joints and a rotated tool frame, the
tolerances are the JAX package's own for its two cores
(tests/test_urdf.py::test_generic_soa_matches_rbd)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_urdf import ARM3_URDF, CARTPOLE_URDF
from torch.utils._python_dispatch import TorchDispatchMode

from parallel_ddp_tpu.models.base import Plant as RefPlant
from parallel_ddp_tpu.models.kuka.rbd import KukaRBD as RefRBD
from parallel_ddp_tpu.ops.integrators import make_step_jacobian as ref_step_jacobian
from parallel_ddp_tpu_torch.models.base import Plant
from parallel_ddp_tpu_torch.models.kuka import model
from parallel_ddp_tpu_torch.models.kuka.rbd import KukaRBD, SerialArmRBD
from parallel_ddp_tpu_torch.models.kuka.soa import KukaSoA
from parallel_ddp_tpu_torch.models.urdf import load_urdf
from parallel_ddp_tpu_torch.ops.integrators import make_step_jacobian

B = 16
REL = 1e-5          # qdd, C, M, EE pose and velocity against the JAX core
REL_AB = 1e-4       # the step Jacobian against the JAX core
CASES = [(0, 0.0), (0, 9.81), (1, 0.0), (1, 9.81)]


def _batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.5, (B, 14)).astype(np.float32),
            rng.normal(0, 2.0, (B, 7)).astype(np.float32))


def _close(got, ref, rel):
    """|got - ref| <= rel * max(max|ref|, 1) (elementwise)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1.0))


@functools.lru_cache(maxsize=None)
def _ref(ee_type, gravity):
    return RefRBD(ee_type=ee_type, gravity=gravity)


@pytest.mark.parametrize("ee_type,gravity", CASES)
def test_dynamics_match_reference(ee_type, gravity):
    x, u = _batch(ee_type * 10 + int(gravity))
    ref, port = _ref(ee_type, gravity), KukaRBD(ee_type, gravity)
    qdd_r = jax.vmap(ref.forward_dynamics)(jnp.asarray(x), jnp.asarray(u))
    qdd = port.forward_dynamics(torch.as_tensor(x), torch.as_tensor(u))
    assert qdd.shape == (B, 7) and qdd.dtype == torch.float32
    _close(qdd, qdd_r, REL)
    c_r, m_r = jax.vmap(ref.bias_and_mass)(jnp.asarray(x[:, :7]), jnp.asarray(x[:, 7:]))
    c, m = port.bias_and_mass(torch.as_tensor(x[:, :7]), torch.as_tensor(x[:, 7:]))
    assert m.shape == (B, 7, 7)
    _close(c, c_r, REL)
    _close(m, m_r, REL)


@pytest.mark.parametrize("ee_type,gravity", CASES)
def test_kinematics_match_reference(ee_type, gravity):
    x, _ = _batch(100 + ee_type)
    ref, port = _ref(ee_type, gravity), KukaRBD(ee_type, gravity)
    _close(port.ee_pose(torch.as_tensor(x[:, :7])),
           jax.vmap(ref.ee_pose)(jnp.asarray(x[:, :7])), REL)
    _close(port.ee_velocity(torch.as_tensor(x)),
           jax.vmap(ref.ee_velocity)(jnp.asarray(x)), REL)
    # the EE cost's pose Jacobian: float32 (forward-mode AD's float64 trap)
    jac = port.ee_pose_jacobian(torch.as_tensor(x[:, :7]))
    assert jac.shape == (B, 6, 7) and jac.dtype == torch.float32
    _close(jac, jax.vmap(jax.jacfwd(ref.ee_pose))(jnp.asarray(x[:, :7])), REL_AB)


@pytest.mark.parametrize("ee_type,gravity,integrator",
                         [c + (1,) for c in CASES] + [(1, 9.81, 3)])
def test_step_jacobian_matches_reference(ee_type, gravity, integrator):
    """The step Jacobian AB (vmapped jacfwd, the solver's derivative stage
    for a plant without kernel hooks), Euler and RK3, against the JAX
    package's, float32 both."""
    x, u = _batch(200 + ee_type)
    dt = 0.5 / 63
    ref, port = _ref(ee_type, gravity), KukaRBD(ee_type, gravity)
    ref_plant = RefPlant(name="ref", n_pos=7, n_ctrl=7, dynamics=ref.forward_dynamics)
    plant = Plant(name="port", n_pos=7, n_ctrl=7, dynamics=port.forward_dynamics)
    ab_r = jax.vmap(ref_step_jacobian(ref_plant, integrator, dt))(jnp.asarray(x), jnp.asarray(u))
    ab = torch.func.vmap(make_step_jacobian(plant, integrator, dt))(torch.as_tensor(x),
                                                                   torch.as_tensor(u))
    assert ab.shape == (B, 14, 21) and ab.dtype == torch.float32
    _close(ab, ab_r, REL_AB)


def test_inverse_dynamics_round_trip_and_batch_dims():
    """tau = M qdd + C recovers the torques (float64); one sample, a flat
    batch and a (4, 4) batch go through the same core."""
    x, u = _batch(7)
    port = KukaRBD(1, 9.81)
    xd, ud = torch.as_tensor(x).double(), torch.as_tensor(u).double()
    qdd = port.forward_dynamics(xd, ud)
    assert qdd.dtype == torch.float64
    torch.testing.assert_close(port.inverse_dynamics(xd[:, :7], xd[:, 7:], qdd), ud,
                               rtol=1e-9, atol=1e-9)
    batched = port.forward_dynamics(torch.as_tensor(x), torch.as_tensor(u))
    single = port.forward_dynamics(torch.as_tensor(x[3]), torch.as_tensor(u[3]))
    assert single.shape == (7,)
    _close(single, batched[3], 1e-6)
    grid = port.forward_dynamics(torch.as_tensor(x).reshape(4, 4, 14),
                                 torch.as_tensor(u).reshape(4, 4, 7))
    _close(grid.reshape(B, 7), batched, 1e-6)
    _close(batched, qdd, 1e-5)


class _Ops(TorchDispatchMode):
    count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += 1
        return func(*args, **(kwargs or {}))


def test_dispatched_ops_stay_few():
    """Each op is a node of the card's graph: the core over leading dims
    dispatches fewer ops than the same code under vmap, and both stay far
    below the joint-by-joint form's 1,716 / 6,796 (measured 527 / 582 for
    the dynamics, 2,558 for the vmapped Euler AB)."""
    port = KukaRBD(1, 0.0)
    x, u = (torch.as_tensor(a) for a in _batch(8))
    ab = torch.func.vmap(make_step_jacobian(
        Plant(name="port", n_pos=7, n_ctrl=7, dynamics=port.forward_dynamics), 1, 0.01))
    counts = {}
    for name, fn in (("dims", lambda: port.forward_dynamics(x, u)),
                     ("vmap", lambda: torch.func.vmap(port.forward_dynamics)(x, u)),
                     ("ab", lambda: ab(x, u))):
        fn()
        with _Ops() as ops:
            fn()
        counts[name] = ops.count
    assert counts["dims"] < counts["vmap"] <= 650, counts
    assert counts["ab"] <= 3000, counts


@pytest.mark.parametrize("ee_type,gravity", [(1, 9.81), (2, 0.0)])
def test_matches_the_scalar_channel_core(ee_type, gravity):
    """The port's two cores on the Kuka: dynamics and bias/mass at the JAX
    package's bounds for its two cores (tests/test_soa.py:35, :43-44)."""
    rng = np.random.default_rng(9)
    x = torch.as_tensor(rng.normal(0, 1.0, (8, 14)).astype(np.float32))
    u = torch.as_tensor(rng.normal(0, 50.0, (8, 7)).astype(np.float32))
    rbd, soa = KukaRBD(ee_type, gravity), KukaSoA(ee_type, gravity)
    np.testing.assert_allclose(rbd.forward_dynamics(x, u), soa.forward_dynamics(x, u),
                               rtol=2e-4, atol=2e-2)
    for a, b, atol in zip(rbd.bias_and_mass(x[:, :7], x[:, 7:]),
                          soa.bias_and_mass(x[:, :7], x[:, 7:]), (1e-3, 1e-4)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=atol)


def test_generic_soa_matches_rbd():
    """Twin of tests/test_urdf.py::test_generic_soa_matches_rbd on the port's
    cores: generic chains, prismatic joints and a rotated tool frame, single
    samples and a batch, at that test's tolerances."""
    rng = np.random.default_rng(0)
    for urdf in (ARM3_URDF, CARTPOLE_URDF):
        arm = load_urdf(urdf)
        n = arm.n
        rbd, soa = arm.rbd(gravity=9.81), arm.soa(gravity=9.81)
        for _ in range(4):
            x = torch.as_tensor(rng.normal(0, 0.8, 2 * n).astype(np.float32))
            u = torch.as_tensor(rng.normal(0, 4.0, n).astype(np.float32))
            qa = rbd.forward_dynamics(x, u).numpy()
            qb = soa.forward_dynamics(x, u).numpy()
            assert np.abs(qa - qb).max() / (1.0 + np.abs(qa).max()) < 1e-5
            np.testing.assert_allclose(soa.ee_pose(x[:n]), rbd.ee_pose(x[:n]), atol=1e-5)
        xs = torch.as_tensor(rng.normal(0, 0.5, (16, 2 * n)).astype(np.float32))
        us = torch.as_tensor(rng.normal(0, 2.0, (16, n)).astype(np.float32))
        np.testing.assert_allclose(soa.forward_dynamics(xs, us), rbd.forward_dynamics(xs, us),
                                   rtol=1e-4, atol=1e-4)


def test_constants_are_made_once_per_device_and_dtype():
    port = KukaRBD(1, 0.0)
    x, u = (torch.as_tensor(a) for a in _batch(10))
    port.forward_dynamics(x, u)
    first = port._consts(x)["i_spatial"]
    port.forward_dynamics(x[:3], u[:3])
    assert port._consts(x)["i_spatial"] is first
    port.forward_dynamics(x.double(), u.double())
    assert len(port._tensors) == 2


def test_joint_types_are_checked():
    arm = load_urdf(CARTPOLE_URDF)
    with pytest.raises(ValueError, match="joint_types"):
        SerialArmRBD(arm.r_tree, arm.p_tree, arm.i_spatial, arm.ee_offset, 9.81,
                     joint_types="rx")


def test_kuka_rbd_core_and_resolve_core():
    """The Kuka's "rbd" core is KukaRBD with no kernel hooks; "auto" resolves
    to it on every device; "cuda" stays the default; typos raise."""
    assert model.resolve_core("auto") == "rbd"
    assert model.resolve_core("soa") == "soa"
    with pytest.raises(ValueError, match="unknown core"):
        model.resolve_core("cuda")
    assert model.resolve_core("cuda", allow_cuda=True) == "cuda"
    with pytest.raises(ValueError, match="unknown core"):
        model.KukaParams(core="pallas")
    assert model.KukaParams().core == "cuda"
    for core in ("rbd", "auto"):
        plant = model.kuka(model.KukaParams(ee_type=1, gravity=0.0, core=core))
        assert plant.name == "kuka_ee1_g0_rbd"
        assert plant.batched_step_jac is None and plant.fused_rollout is None
        assert plant.sim_chain is None
        x, u = (torch.as_tensor(a) for a in _batch(11))
        torch.testing.assert_close(plant.dynamics(x, u),
                                   KukaRBD(1, 0.0).forward_dynamics(x, u), rtol=0, atol=0)
        assert plant.ee_jac(x[:, :7]).shape == (B, 6, 7)
    assert dataclasses.replace(model.KukaParams(), core="soa").resolved_core() == "soa"
