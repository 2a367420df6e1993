"""The solves of tests/test_torch_sp.py's two-rank run, and its worker.

`solves()` runs three mesh solves of the port on CPU tensors: the pendulum
horizon split into 4 'sp' chunks (`make_sp_solver`), a batch of 4 scenarios
over a 'dp' axis of 2 (`make_batched_solver`) and the same batch over a
(dp = 2, sp = 2) mesh (`make_batched_sp_solver`).  Without a process group
every shard lives in this process; `worker` runs them as one rank of a
`gloo` group of 2, where the first holds chunks 0-1 of 4 (the other 2-3),
and the others half the scenarios each.  The test holds the ranks' outputs
to the in-process ones bit for bit.  Imports torch and the port only.
"""

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from parallel_ddp_tpu_torch.parallel.sharding import Mesh, make_batched_solver
from parallel_ddp_tpu_torch.parallel.sp import make_batched_sp_solver, make_sp_solver
from parallel_ddp_tpu_torch.presets import pendulum_swingup

B = 4


def batch_inputs():
    """tests/test_sp.py:109-143's batch: N = 32, seeded controls, goals
    spread around the swing-up."""
    rng = np.random.default_rng(3)
    u0s = torch.as_tensor(rng.normal(0, 0.1, (B, 32, 1)).astype(np.float32))
    goals = torch.as_tensor(np.stack([[np.pi * (0.5 + 0.1 * i), 0.0] for i in range(B)]),
                            dtype=torch.float32)
    return torch.zeros(B, 32, 2), u0s, goals


def solves() -> dict:
    """name -> the SolveOutput's tensors, of the three mesh solves; "held"
    -> the (first, count) shards this process held of the sp solve's 'sp'
    axis and of the 2-D solve's 'dp' axis."""
    prob = pendulum_swingup(num_time_steps=64, m_blocks=8, num_alpha=8)
    cfg = dataclasses.replace(prob.cfg, max_iter=12)
    sp_solver = make_sp_solver(prob.plant, prob.cost, cfg, Mesh((4,), ("sp",)))
    sp = sp_solver(torch.zeros(64, 2), torch.zeros(64, 1), torch.tensor([np.pi, 0.0]))
    small = pendulum_swingup(num_time_steps=32, m_blocks=4, num_alpha=4)
    cfg = dataclasses.replace(small.cfg, max_iter=8)
    x0s, u0s, goals = batch_inputs()
    dp = make_batched_solver(small.plant, small.cost, cfg, Mesh((2,), ("dp",)))(x0s, u0s, goals)
    dpsp_solve = make_batched_sp_solver(small.plant, small.cost, cfg,
                                        Mesh((2, 2), ("dp", "sp")))
    dpsp = dpsp_solve(x0s, u0s, goals)
    held = ((sp_solver.sp.first, sp_solver.sp.count),
            (dpsp_solve.solver.dp.first, dpsp_solve.solver.dp.count))
    return {"sp4": tuple(sp), "dp2": tuple(dp), "dp2_sp2": tuple(dpsp), "held": held}


def worker(rank: int, world: int, init_method: str, out_dir: str) -> None:
    """One rank: join the group, run `solves()`, save what it got."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method, world_size=world, rank=rank)
    try:
        torch.save(solves(), f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()
