from parallel_ddp_tpu_torch.mpc.controls import get_hardware_controls
from parallel_ddp_tpu_torch.mpc.driver import MPCConfig, MPCController, MPCState

__all__ = ["MPCConfig", "MPCController", "MPCState", "get_hardware_controls"]
