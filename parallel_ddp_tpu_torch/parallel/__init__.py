from parallel_ddp_tpu_torch.parallel.backward import backward_pass
from parallel_ddp_tpu_torch.parallel.forward import forward_pass, forward_sweep, multiple_shooting_rollout

__all__ = [
    "backward_pass",
    "forward_pass",
    "forward_sweep",
    "multiple_shooting_rollout",
]
