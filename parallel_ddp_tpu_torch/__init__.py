"""parallel_ddp_tpu_torch — the PyTorch / CUDA port of parallel_ddp_tpu.

The same parallel iLQR solver (block-parallel backward pass, multiple-shooting
forward pass, parallel line search) on torch tensors, with the reference
package's Pallas TPU kernels replaced by CUDA C++ kernels written for the
H100 (`csrc/`, built on first use by `ops/build.py`).  Every kernel op runs
its plain PyTorch version on CPU tensors and its CUDA kernel on CUDA tensors.

The package imports torch and numpy only — never jax or parallel_ddp_tpu —
and sets no global torch flag.  float32 math must stay full precision: the
solver refuses to run on CUDA while TF32 matmuls are enabled.
"""

from parallel_ddp_tpu_torch.config import CostWeights, SolveOutput, SolverConfig
from parallel_ddp_tpu_torch.models.base import Plant
from parallel_ddp_tpu_torch.solver import ilqr_solve, make_ilqr_solver
from parallel_ddp_tpu_torch.parallel.sharding import make_batched_solver
from parallel_ddp_tpu_torch.constraints import (ALConfig, ALMPCController, BoxConstraints,
                                                make_al_solver, solve_al)

__all__ = [
    "SolverConfig",
    "CostWeights",
    "SolveOutput",
    "Plant",
    "ilqr_solve",
    "make_ilqr_solver",
    "make_batched_solver",
    "BoxConstraints",
    "ALConfig",
    "solve_al",
    "make_al_solver",
    "ALMPCController",
]
