from parallel_ddp_tpu_torch.models.base import Plant
from parallel_ddp_tpu_torch.models.cartpole import cartpole
from parallel_ddp_tpu_torch.models.pendulum import pendulum
from parallel_ddp_tpu_torch.models.quadrotor import quadrotor

__all__ = ["Plant", "pendulum", "cartpole", "quadrotor"]
