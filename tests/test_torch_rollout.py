"""The fused-rollout op (parallel_ddp_tpu_torch/ops/cuda_rollout.py) on CPU
tensors — its plain version — against the reference's Pallas rollout kernel
run in interpret mode, on the same seeded inputs (mirrors
tests/test_pallas_rollout.py::test_fused_rollout_matches_xla).

Same channel math and skip-the-last-step masking; float32 with the same
formulas in the same order, so the bound is float32 rounding of a few
integration steps."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_ddp_tpu.ops.pallas_rollout import make_kuka_fused_rollout as ref_fused_rollout
from parallel_ddp_tpu_torch.ops import cuda_rollout
from parallel_ddp_tpu_torch.ops.cuda_rollout import make_kuka_fused_rollout

N, M, A = 4, 2, 3
DT = 0.025


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (
        rng.normal(0, 0.4, (A, N, 14)).astype(f32),    # x_swept
        rng.normal(0, 2.0, (N, 7)).astype(f32),        # u
        rng.normal(0, 0.2, (N, 7, 14)).astype(f32),    # K
        rng.normal(0, 0.5, (N, 7)).astype(f32),        # du
        rng.normal(0, 0.4, (N, 14)).astype(f32),       # xp
        np.asarray([1.0, 0.5, 0.25], f32),             # alphas
    )


def test_rollout_matches_reference_kernel():
    args = _inputs()
    ref = ref_fused_rollout(1, 9.81, 1, DT, N, M, A, interpret=True)
    x_ref, u_ref = ref(*(jnp.asarray(a) for a in args))
    fused = make_kuka_fused_rollout(1, 9.81, 1, DT, N, M, A)
    x_got, u_got = fused(*(torch.as_tensor(a) for a in args))
    assert x_got.shape == (A, M, N // M, 14) and u_got.shape == (A, M, N // M, 7)
    np.testing.assert_allclose(u_got.numpy(), np.asarray(u_ref), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(x_got.numpy(), np.asarray(x_ref), rtol=2e-5, atol=2e-5)
    # the horizon's last step is not simulated: state held, control passed through
    np.testing.assert_array_equal(u_got[:, -1, -1].numpy(), np.broadcast_to(args[1][-1], (A, 7)))
    np.testing.assert_array_equal(x_got[:, -1, -1].numpy(), x_got[:, -1, -2].numpy())


@pytest.mark.parametrize("integrator", [1, 2, 3])
def test_skip_mask_and_integrators(integrator):
    """A call-time skip mask: an interior chunk simulates every step, and a
    masked step freezes the state and passes the control through — checked
    against a step-by-step loop of the port's own integrator step."""
    x_sw, u, K, du, xp, al = (torch.as_tensor(a) for a in _inputs(integrator))
    fused = make_kuka_fused_rollout(1, 9.81, integrator, DT, N, M, A)
    step = cuda_rollout._kuka_step(1, 9.81, integrator, DT)
    for mask in (torch.zeros((M, N // M), dtype=torch.bool),
                 torch.tensor([[False, True], [True, False]])):
        x_got, u_got = fused(x_sw, u, K, du, xp, al, skip_mask=mask)
        for a in range(A):
            for b in range(M):
                x = x_sw[a, b * (N // M)]
                for t in range(N // M):
                    k = b * (N // M) + t
                    if mask[b, t]:
                        u_new = u[k]
                    else:
                        u_new = u[k] - al[a] * du[k] - K[k] @ (x - xp[k])
                        x = step(x, u_new)
                    torch.testing.assert_close(u_got[a, b, t], u_new, rtol=1e-5, atol=1e-5)
                    torch.testing.assert_close(x_got[a, b, t], x, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("integrator", [1, 3])
def test_default_and_given_skip_mask_match_reference_kernel(integrator):
    """The default skip mask (cached per device in the form the kernel takes)
    and the same mask passed by the caller give one result, call after call,
    and it is the reference's fused rollout (interpret mode), Euler and RK3."""
    args = _inputs(40 + integrator)
    ref = ref_fused_rollout(1, 9.81, integrator, DT, N, M, A, interpret=True)
    x_ref, u_ref = ref(*(jnp.asarray(a) for a in args))
    fused = make_kuka_fused_rollout(1, 9.81, integrator, DT, N, M, A)
    targs = [torch.as_tensor(a) for a in args]
    first = fused(*targs)
    again = fused(*targs)                      # the cached mask
    last_only = torch.zeros((M, N // M), dtype=torch.bool)
    last_only[-1, -1] = True
    for mask in (last_only, last_only.to(torch.uint8), last_only.to(torch.int64)):
        given = fused(*targs, skip_mask=mask)
        for a, b, c in zip(first, again, given):
            assert torch.equal(a, b) and torch.equal(a, c)
    np.testing.assert_allclose(first[1].numpy(), np.asarray(u_ref), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(first[0].numpy(), np.asarray(x_ref), rtol=2e-5, atol=2e-5)


def test_kernel_path_refuses_without_a_card():
    """The kernel's wrapper on tensors that are not on a CUDA device raises,
    as it does for a shooting block longer than a thread block can stage."""
    x_sw, u, K, du, xp, al = (torch.as_tensor(a) for a in _inputs())
    skip = torch.zeros((M, N // M), dtype=torch.uint8)
    kw = dict(ee_type=1, gravity=9.81, integrator=1, dt=DT, m_blocks=M)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_rollout.kuka_rollout_cuda(x_sw, u, K, du, xp, al, skip, **kw)
    n_long = cuda_rollout.MAX_BLOCK_STEPS + 1
    long = [torch.zeros((1, n_long, 14)), torch.zeros((n_long, 7)), torch.zeros((n_long, 7, 14)),
            torch.zeros((n_long, 7)), torch.zeros((n_long, 14)), torch.zeros(1),
            torch.zeros((1, n_long), dtype=torch.uint8)]
    with pytest.raises(ValueError, match="steps a shooting block"):
        cuda_rollout.kuka_rollout_cuda(*long, **dict(kw, m_blocks=1))
    assert cuda_rollout.kuka_rollout_cuda.counter.launches == 0


def test_factory_refuses_bad_shapes():
    with pytest.raises(ValueError):
        make_kuka_fused_rollout(1, 9.81, 1, DT, 10, 4, 16)        # N % M != 0
    fused = make_kuka_fused_rollout(1, 9.81, 1, DT, N, M, A)
    x_sw, u, K, du, xp, al = (torch.as_tensor(a) for a in _inputs())
    with pytest.raises(ValueError):
        fused(x_sw, u, K, du, xp, al[:2])                         # wrong alpha count
    meta = [t.to("meta") for t in (x_sw, u, K, du, xp, al)]
    with pytest.raises(ValueError, match="CUDA"):
        fused(*meta)                                              # never the plain version
    assert cuda_rollout.kuka_rollout_cuda.counter.launches == 0
