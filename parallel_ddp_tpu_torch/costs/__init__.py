from parallel_ddp_tpu_torch.costs.base import CostModel
from parallel_ddp_tpu_torch.costs.ee import ee_cost

__all__ = ["CostModel", "ee_cost"]
