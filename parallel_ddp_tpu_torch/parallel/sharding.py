"""Scenario batching on one card (twin of `parallel_ddp_tpu/parallel/sharding.py`).

The reference vmaps thousands of independent solves into one program and
shards the scenario axis over a device mesh.  Here the scenario axis is a
leading batch axis of the solver's one iteration body (`solver.py`): on the
card a batched solve is one CUDA-graph replay whose kernels take every
scenario in each launch (the Riccati sweep's lanes are scenarios x time
blocks, the rollout's grid has a scenario axis, the dynamics kernels take the
scenarios' samples flattened); on the CPU it is a host loop that runs while
any scenario is active.  One card takes the whole batch: a device mesh (and
`make_mesh`, `shard_map`) is not ported.
"""

from __future__ import annotations

from typing import Optional

from parallel_ddp_tpu_torch.config import CostWeights, SolverConfig
from parallel_ddp_tpu_torch.costs.base import CostModel
from parallel_ddp_tpu_torch.models.base import Plant
from parallel_ddp_tpu_torch.solver import make_ilqr_solver


def make_batched_solver(
    plant: Plant,
    cost: CostModel,
    cfg: SolverConfig,
    mesh=None,
    batch_axis: str = "dp",
    initial_rollout: bool = True,
):
    """Return solve_batch(x0s, u0s, goals, weights=None) -> SolveOutput.

    x0s: (B, N, n), u0s: (B, N, m), goals: a pytree with a leading B on each
    tensor leaf; the weights and the iteration cap (cfg.max_iter) are shared.
    Every scenario is an independent solve (the reference's
    `jax.vmap(solver)`): each commits under its own ~done & (it <= cap) and
    the batch runs while any scenario is active.  Each leaf of the output
    has a leading B.  `mesh` must be None (one card; a mesh raises
    NotImplementedError); `batch_axis` names the reference's mesh axis and is
    unused here.  `solve_batch.solver` is the solver (its `graphs` and
    `host_syncs`)."""
    if mesh is not None:
        raise NotImplementedError(
            "scenario batching over a device mesh is not ported: one card takes the "
            "whole batch (pass mesh=None)")
    solver = make_ilqr_solver(plant, cost, cfg)

    def solve_batch(x0s, u0s, goals, weights: Optional[CostWeights] = None):
        return solver.solve_batch(x0s, u0s, goals, weights, initial_rollout=initial_rollout)

    solve_batch.solver = solver
    return solve_batch
