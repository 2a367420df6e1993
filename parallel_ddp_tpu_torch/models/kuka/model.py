"""Kuka iiwa-14 Plant wrapper (twin of `parallel_ddp_tpu/models/kuka/model.py`;
PLANT == 4 in the reference, config.cuh:43-58)."""

from __future__ import annotations

import dataclasses
import functools

from parallel_ddp_tpu_torch.models.base import Plant
from parallel_ddp_tpu_torch.models.kuka.soa import KukaSoA

CORES = ("cuda", "soa")


@dataclasses.dataclass(frozen=True)
class KukaParams:
    ee_type: int = 1
    gravity: float = 9.81  # 0.0 reproduces MPC_MODE gravity-comp (dynamics_arm.cuh:42-46)
    # Dynamics core selection:
    #   "cuda" the counterpart of the reference's core="pallas": per-sample
    #          ops on the soa core; the solver's derivative stage runs through
    #          the RBD-Jacobian op (ops/cuda_rbd.py) and the multiple-shooting
    #          forward simulation through the rollout op (ops/cuda_rollout.py).
    #          Both ops launch their CUDA kernels on CUDA tensors and use
    #          their plain PyTorch versions on CPU tensors.
    #   "soa"  the same plant without those hooks.
    core: str = "cuda"

    def __post_init__(self):
        if self.core not in CORES:
            raise ValueError(f"unknown core {self.core!r}; expected one of {CORES}")


@functools.lru_cache(maxsize=8)
def _soa(ee_type: int, gravity: float) -> KukaSoA:
    return KukaSoA(ee_type=ee_type, gravity=gravity)


def kuka_params(mpc_mode: bool = False, ee_type: int = 1, core: str = "cuda") -> KukaParams:
    return KukaParams(ee_type=ee_type, gravity=0.0 if mpc_mode else 9.81, core=core)


def kuka(params: KukaParams | None = None) -> Plant:
    params = params or KukaParams()
    rbd = _soa(params.ee_type, params.gravity)
    batched_step_jac = None
    fused_rollout = None
    if params.core == "cuda":
        from parallel_ddp_tpu_torch.ops.cuda_rbd import make_kuka_ab
        from parallel_ddp_tpu_torch.ops.cuda_rollout import make_kuka_fused_rollout

        def batched_step_jac(integrator, dt, _p=params):
            return make_kuka_ab(_p.ee_type, _p.gravity, integrator, dt)

        def fused_rollout(integrator, dt, num_time_steps, m_blocks_f, num_alpha,
                          _p=params):
            return make_kuka_fused_rollout(
                _p.ee_type, _p.gravity, integrator, dt,
                num_time_steps, m_blocks_f, num_alpha,
            )

    return Plant(
        name=f"kuka_ee{params.ee_type}_g{params.gravity:g}_{params.core}",
        n_pos=7,
        n_ctrl=7,
        dynamics=rbd.forward_dynamics,
        ee_pos=rbd.ee_pose,
        ee_vel=rbd.ee_velocity,
        rho_init_default=12.5,
        max_defect_default=1.0,
        alpha_base_default=0.5,
        num_alpha_default=16,
        batched_step_jac=batched_step_jac,
        fused_rollout=fused_rollout,
    )
