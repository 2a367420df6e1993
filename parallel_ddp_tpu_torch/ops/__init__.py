from parallel_ddp_tpu_torch.ops.integrators import make_step, make_step_jacobian

__all__ = ["make_step", "make_step_jacobian"]
