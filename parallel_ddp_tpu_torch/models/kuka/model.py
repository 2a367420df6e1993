"""Kuka iiwa-14 Plant wrapper (twin of `parallel_ddp_tpu/models/kuka/model.py`;
PLANT == 4 in the reference, config.cuh:43-58)."""

from __future__ import annotations

import dataclasses
import functools

from parallel_ddp_tpu_torch.models.base import Plant
from parallel_ddp_tpu_torch.models.kuka.rbd import KukaRBD
from parallel_ddp_tpu_torch.models.kuka.soa import KukaSoA

CORES = ("cuda", "soa", "rbd")


@dataclasses.dataclass(frozen=True)
class KukaParams:
    ee_type: int = 1
    gravity: float = 9.81  # 0.0 reproduces MPC_MODE gravity-comp (dynamics_arm.cuh:42-46)
    # Dynamics core selection:
    #   "cuda" the counterpart of the reference's core="pallas": the plant
    #          dynamics run through the forward-dynamics op (ops/cuda_rbd.py
    #          kuka_qdd), the solver's derivative stage through the
    #          RBD-Jacobian op (same module), the multiple-shooting forward
    #          simulation through the rollout op (ops/cuda_rollout.py) and
    #          chains of plant steps (MPC warm start, cold rollout, plant
    #          substeps) through the chain op (ops/cuda_sim_chain.py).  Each
    #          op launches its CUDA kernel on CUDA tensors and uses its plain
    #          PyTorch version (the soa core) on CPU tensors.
    #   "soa"  the same plant without those hooks.
    #   "rbd"  the spatial-algebra core (models/kuka/rbd.py), no hooks: the
    #          independent oracle, as in the JAX package.
    #   "auto" rbd (`resolve_core`).
    core: str = "cuda"

    def __post_init__(self):
        self.resolved_core()

    def resolved_core(self) -> str:
        return resolve_core(self.core, allow_cuda=True)


def resolve_core(core: str, allow_cuda: bool = False) -> str:
    """Shared backend-selection policy (used by KukaParams and urdf_plant so
    the two never drift): the JAX package's rule, "auto" = the scalar-channel
    core on a TPU and the spatial-algebra core everywhere else.  This package
    never runs on a TPU, so "auto" is "rbd" on every device.  "cuda" (the
    Kuka's kernel hooks) only where allow_cuda."""
    allowed = (set(CORES) | {"auto"}) if allow_cuda else {"auto", "soa", "rbd"}
    if core not in allowed:
        raise ValueError(f"unknown core {core!r}; expected one of {sorted(allowed)}")
    return "rbd" if core == "auto" else core


@functools.lru_cache(maxsize=8)
def _core(ee_type: int, gravity: float, core: str):
    return (KukaRBD if core == "rbd" else KukaSoA)(ee_type=ee_type, gravity=gravity)


def kuka_params(mpc_mode: bool = False, ee_type: int = 1, core: str = "cuda") -> KukaParams:
    return KukaParams(ee_type=ee_type, gravity=0.0 if mpc_mode else 9.81, core=core)


def kuka(params: KukaParams | None = None) -> Plant:
    params = params or KukaParams()
    core = params.resolved_core()
    rbd = _core(params.ee_type, params.gravity, core)
    dynamics = rbd.forward_dynamics
    batched_step_jac = None
    fused_rollout = None
    sim_chain = None
    if core == "cuda":
        from parallel_ddp_tpu_torch.ops.cuda_rbd import kuka_qdd, make_kuka_ab
        from parallel_ddp_tpu_torch.ops.cuda_rollout import make_kuka_fused_rollout
        from parallel_ddp_tpu_torch.ops.cuda_sim_chain import make_kuka_sim_chain

        dynamics = functools.partial(kuka_qdd, ee_type=params.ee_type,
                                     gravity=params.gravity)

        def batched_step_jac(integrator, dt, _p=params):
            return make_kuka_ab(_p.ee_type, _p.gravity, integrator, dt)

        def fused_rollout(integrator, dt, num_time_steps, m_blocks_f, num_alpha,
                          _p=params):
            return make_kuka_fused_rollout(
                _p.ee_type, _p.gravity, integrator, dt,
                num_time_steps, m_blocks_f, num_alpha,
            )

        def sim_chain(integrator, dt, _p=params):
            return make_kuka_sim_chain(_p.ee_type, _p.gravity, integrator, dt)

    return Plant(
        name=f"kuka_ee{params.ee_type}_g{params.gravity:g}_{core}",
        n_pos=7,
        n_ctrl=7,
        dynamics=dynamics,
        ee_pos=rbd.ee_pose,
        ee_vel=rbd.ee_velocity,
        ee_jac=rbd.ee_pose_jacobian,
        rho_init_default=12.5,
        max_defect_default=1.0,
        alpha_base_default=0.5,
        num_alpha_default=16,
        batched_step_jac=batched_step_jac,
        fused_rollout=fused_rollout,
        sim_chain=sim_chain,
    )
