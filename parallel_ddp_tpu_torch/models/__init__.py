from parallel_ddp_tpu_torch.models.base import Plant
from parallel_ddp_tpu_torch.models.cartpole import cartpole
from parallel_ddp_tpu_torch.models.pendulum import pendulum
from parallel_ddp_tpu_torch.models.quadrotor import quadrotor
from parallel_ddp_tpu_torch.models.urdf import load_urdf, urdf_plant

__all__ = ["Plant", "pendulum", "cartpole", "quadrotor", "load_urdf", "urdf_plant"]
