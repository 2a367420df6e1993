from parallel_ddp_tpu_torch.costs.base import CostModel
from parallel_ddp_tpu_torch.costs.ee import ee_cost
from parallel_ddp_tpu_torch.costs.joint import (cartpole_cost, fixed_diag_cost, joint_cost,
                                                pendulum_cost, quadrotor_cost)

__all__ = ["CostModel", "ee_cost", "fixed_diag_cost", "pendulum_cost", "cartpole_cost",
           "quadrotor_cost", "joint_cost"]
