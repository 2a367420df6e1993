from parallel_ddp_tpu_torch.utils.profiling import phase_times, timing_stats, AlgTrace

__all__ = ["phase_times", "timing_stats", "AlgTrace"]
