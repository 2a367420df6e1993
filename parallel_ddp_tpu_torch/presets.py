"""Ready-made (plant, cost, config) problems (twin of
`parallel_ddp_tpu/presets.py`): the WAFR example's five problems
(examples/WAFR_iLQR_examples.cu) with the JAX package's defaults field for
field, the EE goal helpers and the figure-8 task path."""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np
import torch

from parallel_ddp_tpu_torch.config import CostWeights, SolverConfig
from parallel_ddp_tpu_torch.costs.base import CostModel
from parallel_ddp_tpu_torch.costs.ee import (
    KUKA_POS_LIMITS,
    KUKA_TORQUE_LIMITS,
    KUKA_VEL_LIMITS,
    ee_cost,
)
from parallel_ddp_tpu_torch.costs.joint import (
    cartpole_cost,
    joint_cost,
    pendulum_cost,
    quadrotor_cost,
)
from parallel_ddp_tpu_torch.device import default_device
from parallel_ddp_tpu_torch.models import cartpole, pendulum, quadrotor
from parallel_ddp_tpu_torch.models.base import Plant
from parallel_ddp_tpu_torch.models.kuka import kuka, kuka_params

# the figure-8 task path (200 points; the package's own copy of the data)
FIG8_GOALS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "fig8_goals.npz")


class Problem(NamedTuple):
    plant: Plant
    cost: CostModel
    cfg: SolverConfig


def pendulum_swingup(num_time_steps=128, total_time=4.0, m_blocks=4, num_alpha=16):
    cfg = SolverConfig(
        num_time_steps=num_time_steps, total_time=total_time,
        m_blocks_b=m_blocks, m_blocks_f=m_blocks, num_alpha=num_alpha,
        alpha_base=0.75, integrator=3, rho_init=10.0,
    )
    return Problem(pendulum(), pendulum_cost(num_time_steps), cfg)


def cartpole_swingup(num_time_steps=128, total_time=4.0, m_blocks=4, num_alpha=32):
    cfg = SolverConfig(
        num_time_steps=num_time_steps, total_time=total_time,
        m_blocks_b=m_blocks, m_blocks_f=m_blocks, num_alpha=num_alpha,
        alpha_base=0.75, integrator=3, rho_init=10.0, max_defect_size=0.75,
    )
    return Problem(cartpole(), cartpole_cost(num_time_steps), cfg)


def quadrotor_task(num_time_steps=128, total_time=4.0, m_blocks=4, num_alpha=16):
    cfg = SolverConfig(
        num_time_steps=num_time_steps, total_time=total_time,
        m_blocks_b=m_blocks, m_blocks_f=m_blocks, num_alpha=num_alpha,
        alpha_base=0.5, integrator=3, rho_init=1.0,
    )
    return Problem(quadrotor(), quadrotor_cost(num_time_steps), cfg)


def kuka_joint(num_time_steps=64, total_time=0.5, m_blocks=4, num_alpha=16,
               integrator=1, mpc_mode=False, core="cuda"):
    """Kuka N=64 joint-space problem, the WAFR benchmark scale
    (config.cuh:43-58): full gravity unless `mpc_mode`.  `core="cuda"`
    routes the derivative stage, the forward simulation and the chains
    through the kernel ops (`models/kuka/model.py`)."""
    plant = kuka(kuka_params(mpc_mode=mpc_mode, core=core))
    cfg = SolverConfig(
        num_time_steps=num_time_steps, total_time=total_time,
        m_blocks_b=m_blocks, m_blocks_f=m_blocks, num_alpha=num_alpha,
        alpha_base=0.5, integrator=integrator, rho_init=12.5,
    )
    return Problem(plant, joint_cost("kuka_joint", num_time_steps, 7, 7), cfg)


def kuka_ee(num_time_steps=64, total_time=0.5, m_blocks=4, num_alpha=16,
            integrator=1, mpc_mode=True, use_smooth_abs=False, use_limits=False,
            use_ee_vel=False, core="cuda"):
    """Kuka EE-pose tracking problem (the MPC figure-8 config; EE_COST=1,
    examples/LCM_fig8_examples.cu).  Defaults are the WAFR configuration:
    N = 64 over 0.5 s, 4 backward and 4 forward blocks, 16 alphas, Euler,
    gravity-compensated MPC mode.

    `core="cuda"` routes the derivative stage and the forward simulation
    through the kernel ops (`models/kuka/model.py`)."""
    plant = kuka(kuka_params(mpc_mode=mpc_mode, core=core))
    cfg = SolverConfig(
        num_time_steps=num_time_steps, total_time=total_time,
        m_blocks_b=m_blocks, m_blocks_f=m_blocks, num_alpha=num_alpha,
        alpha_base=0.5, integrator=integrator, rho_init=12.5,
        ee_cost=True, use_smooth_abs=use_smooth_abs, use_limits=use_limits,
    )
    cost = ee_cost(
        plant.ee_pos, plant.ee_jac, 7, 7, num_time_steps,
        use_smooth_abs=use_smooth_abs,
        smooth_abs_alpha=cfg.smooth_abs_alpha,
        use_ee_vel=use_ee_vel,
        use_limits=use_limits,
        pos_limits=KUKA_POS_LIMITS,
        vel_limits=KUKA_VEL_LIMITS,
        torque_limits=KUKA_TORQUE_LIMITS,
    )
    return Problem(plant, cost, cfg)


def ee_goal(xyz, rpy=(0.0, 0.0, 0.0), x_target=None, n_state: int = 14,
            device=None):
    """Goal dict for the EE cost family, as float32 tensors on `device`
    (default: the card, `device.default_device()`; "cpu" to ask for the CPU)."""
    f32 = dict(dtype=torch.float32,
               device=default_device() if device is None else device)
    return {
        "ee_goal": torch.as_tensor(np.concatenate([np.asarray(xyz, np.float32),
                                                   np.asarray(rpy, np.float32)]), **f32),
        "x_target": (torch.zeros((n_state,), **f32) if x_target is None
                     else torch.as_tensor(np.asarray(x_target, np.float32), **f32)),
    }


@functools.lru_cache(maxsize=1)
def _fig8_path():
    with np.load(FIG8_GOALS) as data:
        return np.stack([data["x"], data["y"], data["z"]], axis=-1)  # (200, 3)


def figure8_goal(t, total_time=10.0):
    """EE xyz goal on the WAFR/ICRA figure-8 at time t.

    The 200-point task path of the reference benchmark
    (LCM_fig8_examples.cu:102-104), linearly interpolated and wrapped like
    loadFig8Goal (:114-122).  Returns (goal_xyz (3,) numpy, rep)."""
    pts = _fig8_path()
    num = pts.shape[0]
    tstep = total_time / (num - 1)
    gnum = t / tstep
    frac = gnum - np.floor(gnum)
    rep = int(np.floor(gnum)) // num
    rd = int(np.floor(gnum)) % num
    ru = int(np.ceil(gnum)) % num
    return (1 - frac) * pts[rd] + frac * pts[ru], rep


def fig8_weights():
    """The reference's figure-8 tracking weights (LCM_fig8_examples.cu:47-59,
    hardware variant: Q_EE1 = QF_EE1 = 300, R_EE = 5e-4, Q_xdEE = QF_xdEE = 10,
    Q_xEE = QF_xEE = 1)."""
    return CostWeights(
        q_ee1=300.0, q_ee2=1e-6, qf_ee1=300.0, qf_ee2=1e-6,
        r_ee=0.0005, q_xdee=10.0, qf_xdee=10.0, q_xee=1.0, qf_xee=1.0,
    )
