from parallel_ddp_tpu_torch.models.base import Plant

__all__ = ["Plant"]
