"""The port's scalar-channel Kuka dynamics (parallel_ddp_tpu_torch/models/kuka/
soa.py) against the reference's KukaSoA, on the same seeded batch.

Both run the same float32 formulas in the same order, so they agree to the
last bits: the bound is a few float32 ulps of the largest value (the
backends' sin/cos may round differently), amplified for qdd by the mass
matrix's condition number (~1e3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_ddp_tpu.models.kuka.soa import KukaSoA as RefSoA
from parallel_ddp_tpu_torch.models.kuka.soa import KukaSoA

B = 16


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.5, (B, 14)).astype(np.float32)
    u = rng.normal(0, 2.0, (B, 7)).astype(np.float32)
    return x, u


def _close(got, ref, rel):
    """|got - ref| <= rel * max|ref| (elementwise)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1.0))


@pytest.mark.parametrize("gravity", [0.0, 9.81])
@pytest.mark.parametrize("ee_type", [1, 2])
def test_qdd_matches_reference(ee_type, gravity):
    x, u = _batch(ee_type)
    ref = RefSoA(ee_type, gravity).forward_dynamics(jnp.asarray(x), jnp.asarray(u))
    got = KukaSoA(ee_type, gravity).forward_dynamics(torch.as_tensor(x), torch.as_tensor(u))
    assert got.shape == (B, 7) and got.dtype == torch.float32
    _close(got, ref, 2e-6)


def test_bias_and_mass_matches_reference():
    x, _ = _batch(3)
    c_ref, m_ref = RefSoA(1, 9.81).bias_and_mass(jnp.asarray(x[:, :7]), jnp.asarray(x[:, 7:]))
    c, m = KukaSoA(1, 9.81).bias_and_mass(torch.as_tensor(x[:, :7]), torch.as_tensor(x[:, 7:]))
    assert m.shape == (B, 7, 7)
    _close(c, c_ref, 1e-6)
    _close(m, m_ref, 1e-6)


@pytest.mark.parametrize("ee_type", [0, 1, 2])
def test_ee_pose_and_velocity_match_reference(ee_type):
    x, _ = _batch(4)
    ref, port = RefSoA(ee_type, 0.0), KukaSoA(ee_type, 0.0)
    _close(port.ee_pose(torch.as_tensor(x[:, :7])), ref.ee_pose(jnp.asarray(x[:, :7])), 1e-6)
    _close(port.ee_velocity(torch.as_tensor(x)), ref.ee_velocity(jnp.asarray(x)), 1e-6)


def test_single_sample_and_float64():
    """One sample (no batch dims) and float64 go through the same core."""
    x, u = _batch(5)
    port = KukaSoA(1, 0.0)
    batched = port.forward_dynamics(torch.as_tensor(x), torch.as_tensor(u))
    single = port.forward_dynamics(torch.as_tensor(x[2]), torch.as_tensor(u[2]))
    assert single.shape == (7,)
    torch.testing.assert_close(single, batched[2], rtol=0, atol=0)
    f64 = port.forward_dynamics(torch.as_tensor(x).double(), torch.as_tensor(u).double())
    assert f64.dtype == torch.float64
    _close(batched, f64, 2e-6)


def test_inverse_dynamics_round_trip():
    """tau = M qdd + C recovers the torques the forward dynamics was given."""
    x, u = _batch(6)
    port = KukaSoA(1, 9.81)
    xd, ud = torch.as_tensor(x).double(), torch.as_tensor(u).double()
    qdd = port.forward_dynamics(xd, ud)
    tau = port.inverse_dynamics(xd[:, :7], xd[:, 7:], qdd)
    torch.testing.assert_close(tau, ud, rtol=1e-9, atol=1e-9)
