"""Plant protocol (twin of `parallel_ddp_tpu/models/base.py`).

A plant is a small frozen dataclass of plain functions on tensors: state
x = [q; qd], control u, qdd = dynamics(x, u).  The functions take any leading
batch dimensions, so a whole time axis or (alpha, block) grid is one call.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class Plant:
    """A second-order plant.

    Attributes:
      name: plant id.
      n_pos / n_ctrl: number of generalized coordinates / controls.
      dynamics: (x (..., 2*n_pos), u (..., n_ctrl)) -> qdd (..., n_pos).
      dynamics_jac: optional hand-written (x, u) -> (n_pos, 2*n_pos+n_ctrl)
        for one sample; defaults to `torch.func.jacfwd` of `dynamics`.
      ee_pos: optional q (..., n_pos) -> (..., 6) end-effector pose [xyz, rpy].
      ee_vel: optional x (..., 2*n_pos) -> (..., 6) end-effector twist.
      *_default: per-plant solver defaults (config.cuh:24-58).
      batched_step_jac: optional factory (integrator, dt) ->
        ab(xs (B, n_state), us (B, n_ctrl)) -> (B, n_state, n_state+n_ctrl):
        the solver's derivative stage calls it on the whole time axis at once
        (the hook that routes the RBD-Jacobian kernel onto the main path).
      fused_rollout: optional factory (integrator, dt, num_time_steps,
        m_blocks_f, num_alpha) -> fused(x_swept, u, K, du, xp, alphas) ->
        (x_next_all, u_new_all): the whole multiple-shooting forward
        simulation in one op (`ops/cuda_rollout.py`).
    """

    name: str
    n_pos: int
    n_ctrl: int
    dynamics: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    dynamics_jac: Optional[Callable] = None
    ee_pos: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    ee_vel: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    rho_init_default: float = 1.0
    max_defect_default: float = 1.0
    alpha_base_default: float = 0.75
    num_alpha_default: int = 32
    batched_step_jac: Optional[Callable[[int, float], Callable]] = None
    fused_rollout: Optional[Callable[[int, float, int, int, int], Callable]] = None

    def __hash__(self):
        return hash((self.name, self.n_pos, self.n_ctrl))

    def __eq__(self, other):
        return isinstance(other, Plant) and (self.name, self.n_pos, self.n_ctrl) == (
            other.name,
            other.n_pos,
            other.n_ctrl,
        )

    @property
    def n_state(self) -> int:
        return 2 * self.n_pos

    def qdd_jacobian(self) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
        """d qdd / d [x; u] of one sample as an (n_pos, n_state + n_ctrl)
        matrix (the reference's `dynamicsGradient` contract)."""
        if self.dynamics_jac is not None:
            return self.dynamics_jac

        def jac(x, u):
            dx, du = torch.func.jacfwd(self.dynamics, argnums=(0, 1))(x, u)
            return torch.cat([dx, du], dim=1)

        return jac
