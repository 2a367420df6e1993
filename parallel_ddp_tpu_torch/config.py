"""Solver configuration and runtime-tunable cost weights.

Field-for-field twin of `parallel_ddp_tpu/config.py`, with the same defaults,
so a configuration maps 1:1 between the two packages (`interop.py`).

  * `SolverConfig` — static options that shape the solve (horizon, block
    counts, integrator, line-search width ...).
  * `CostWeights` — the runtime-tunable cost weights (plain floats).
  * `SolveOutput` — the result of one solve, as tensors on the solve's device.

Some fields select JAX-package features that this package does not have yet
(`bp_assoc_scan`, `use_finite_diff`, `bf16_rollout`, `bf16_cost`); they are
kept so configurations map 1:1, and the solver raises if one is switched on.
`scan_unroll` has nothing to act on here (there is no `lax.scan`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static solver options (see `parallel_ddp_tpu.config.SolverConfig` for
    the meaning of each field).

    `pallas_riccati` keeps the reference's name so configurations map 1:1;
    here it means "the backward sweep goes through the fused Riccati op"
    (`ops/cuda_riccati.py`)."""

    num_time_steps: int = 64
    total_time: float = 0.5
    m_blocks_b: int = 4
    m_blocks_f: int = 4
    num_alpha: int = 16
    alpha_base: float = 0.5
    integrator: int = 3
    max_iter: int = 100
    tol_cost: float = 0.0001
    use_exp_red: bool = True
    exp_red_min: float = 0.05
    exp_red_max: float = 1.25
    use_max_defect: bool = True
    max_defect_size: float = 1.0
    alpha_best_switch: bool = True
    state_reg: bool = True
    rho_init: float = 12.5
    rho_max: float = 1e7
    rho_min: float = 0.01
    rho_factor: float = 1.25
    ignore_max_rho_exit: bool = True
    max_bp_retries: int = 40
    linear_transform_switch: bool = True
    use_smooth_abs: bool = False
    smooth_abs_alpha: float = 0.2
    use_limits: bool = False
    ee_cost: bool = False
    slq: bool = False
    use_finite_diff: bool = False
    fd_eps: float = 1e-4
    bp_assoc_scan: bool = False
    scan_unroll: int = 4
    bf16_rollout: bool = False
    bf16_cost: bool = False
    pallas_riccati: bool = False

    @property
    def dt(self) -> float:
        return self.total_time / (self.num_time_steps - 1)

    @property
    def n_blocks_b(self) -> int:
        return self.num_time_steps // self.m_blocks_b

    @property
    def n_blocks_f(self) -> int:
        return self.num_time_steps // self.m_blocks_f

    def __post_init__(self):
        if self.num_time_steps % self.m_blocks_b != 0:
            raise ValueError("num_time_steps must be divisible by m_blocks_b")
        if self.num_time_steps % self.m_blocks_f != 0:
            raise ValueError("num_time_steps must be divisible by m_blocks_f")
        if self.integrator not in (1, 2, 3):
            raise ValueError("integrator must be 1 (Euler), 2 (Midpoint) or 3 (RK3)")
        if self.bp_assoc_scan and self.state_reg:
            raise ValueError(
                "bp_assoc_scan requires state_reg=False (plain Huu += rho I "
                "regularization folds into the scan elements; Tassa state-reg "
                "does not)"
            )
        if self.bp_assoc_scan and self.pallas_riccati:
            raise ValueError(
                "bp_assoc_scan and pallas_riccati are mutually exclusive "
                "backward-pass strategies"
            )

    def alphas(self) -> np.ndarray:
        """Line-search step sizes alpha_i = alpha_base**i, as a float32 numpy
        array (the same values as the reference's `alphas()`)."""
        return np.power(
            np.asarray(self.alpha_base, np.float32),
            np.arange(self.num_alpha, dtype=np.float32),
        )


class CostWeights(NamedTuple):
    """Runtime-tunable cost weights (defaults: cost_arm.cuh:96-120).

    Joint-space family: q1, q2, r, qf1, qf2.  EE family: q_ee1/q_ee2 (xyz /
    rpy), qf_* terminal, *_eev* EE velocity, r_ee control, q_xdee/qf_xdee and
    q_xee/qf_xee nominal-state regularizers.  Limit penalties: q_pl/q_vl/r_tl.
    """

    q1: float = 0.1
    q2: float = 0.001
    r: float = 0.0001
    qf1: float = 1000.0
    qf2: float = 1000.0
    q_ee1: float = 0.1
    q_ee2: float = 0.0
    qf_ee1: float = 1000.0
    qf_ee2: float = 0.0
    q_eev1: float = 0.0
    q_eev2: float = 0.0
    qf_eev1: float = 0.0
    qf_eev2: float = 0.0
    r_ee: float = 0.0001
    q_xdee: float = 0.1
    qf_xdee: float = 1000.0
    q_xee: float = 0.0
    qf_xee: float = 0.0
    q_pl: float = 100.0
    q_vl: float = 100.0
    r_tl: float = 100.0


class SolveOutput(NamedTuple):
    """Result of one iLQR solve (tensors on the solve's device)."""

    x: torch.Tensor          # (N, n_state) accepted trajectory
    u: torch.Tensor          # (N, n_ctrl) accepted controls
    K: torch.Tensor          # (N, n_ctrl, n_state) feedback gains
    d: torch.Tensor          # (N, n_state) multiple-shooting defects
    P: torch.Tensor          # (N, n_state, n_state) cost-to-go Hessians
    p: torch.Tensor          # (N, n_state) cost-to-go gradients
    J: torch.Tensor          # scalar final cost
    iters: int               # iterations executed
    J_trace: torch.Tensor    # (max_iter+1,) cost per iteration
    alpha_trace: torch.Tensor  # (max_iter+1,) accepted alpha index, -1 = rejected
    rho: torch.Tensor        # final regularizer
    max_defect: torch.Tensor  # final max defect
    converged: torch.Tensor = None
    last_feasible: torch.Tensor = None
    defect_trace: torch.Tensor = None
