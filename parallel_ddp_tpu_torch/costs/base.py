"""Cost model protocol (twin of `parallel_ddp_tpu/costs/base.py`).

A cost model provides the running/terminal cost and its (state+control)
gradient and Hessian — the reference's per-plant `costFunc` / `costGrad`
contract (cost_arm.cuh:126-390) — evaluated over the time axis as a batch:
`k` is a tensor of knot indices broadcast against the leading dims of x and u,
and terminal behaviour switches on k == N-1.  `goal` is a dict of tensors
interpreted by the specific model; `w` is a `CostWeights` of floats.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from parallel_ddp_tpu_torch.config import CostWeights


@dataclasses.dataclass(frozen=True)
class CostModel:
    """stage(x (..., n), u (..., m), k (...), goal, w) -> (...);
    quad(x, u, k, goal, w) -> (H (..., n+m, n+m), g (..., n+m)), blocks
    ordered [x; u]."""

    name: str
    stage: Callable[[torch.Tensor, torch.Tensor, Any, Any, CostWeights], torch.Tensor]
    quad: Callable[[torch.Tensor, torch.Tensor, Any, Any, CostWeights], tuple]

    def __hash__(self):
        return hash(self.name)

    def __eq__(self, other):
        return isinstance(other, CostModel) and self.name == other.name
