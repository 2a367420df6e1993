from parallel_ddp_tpu_torch.models.kuka.model import kuka, KukaParams, kuka_params

__all__ = ["kuka", "KukaParams", "kuka_params"]
