"""Ready-made (plant, cost, config) problems (twin of the Kuka part of
`parallel_ddp_tpu/presets.py`)."""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np
import torch

from parallel_ddp_tpu_torch.config import SolverConfig
from parallel_ddp_tpu_torch.costs.base import CostModel
from parallel_ddp_tpu_torch.costs.ee import (
    KUKA_POS_LIMITS,
    KUKA_TORQUE_LIMITS,
    KUKA_VEL_LIMITS,
    ee_cost,
)
from parallel_ddp_tpu_torch.models.base import Plant
from parallel_ddp_tpu_torch.models.kuka import kuka, kuka_params

# the figure-8 task path lives, as data, in the reference package's tree
FIG8_GOALS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "parallel_ddp_tpu", "tasks", "fig8_goals.npz")


class Problem(NamedTuple):
    plant: Plant
    cost: CostModel
    cfg: SolverConfig


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
        plant.ee_pos, 7, 7, num_time_steps,
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
    """Goal dict for the EE cost family, as float32 tensors on `device`."""
    f32 = dict(dtype=torch.float32, device=device)
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
