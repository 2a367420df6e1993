"""Scenario batching and the shard mesh (twin of `parallel_ddp_tpu/parallel/sharding.py`).

The reference vmaps thousands of independent solves into one program and
shards the scenario axis over a device mesh.  Here the scenario axis is a
leading batch axis of the solver's one iteration body (`solver.py`): on the
card a batched solve is one CUDA-graph replay whose kernels take every
scenario in each launch (the Riccati sweep's lanes are scenarios x time
blocks, the rollout's grid has a scenario axis, the dynamics kernels take the
scenarios' samples flattened); on the CPU it is a host loop that runs while
any scenario is active.

The mesh (`Mesh`, `make_mesh`) has named axes with sizes, as
`jax.sharding.Mesh` has; each of its entries is a *shard*, what a JAX device
is to `shard_map`.  Where the shards live:
  * without a `torch.distributed` process group, all in this process: the
    shards of an axis are a dim of the tensors, on the inputs' device (one
    card runs a whole mesh this way);
  * with a process group of W ranks (W divides the shard count), rank r holds
    the shards r*size/W .. (r+1)*size/W - 1 in row-major order, JAX's device
    order, which must form a box of the mesh.  `gloo` serves CPU tensors,
    `nccl` CUDA tensors, one rank a card.
`Collectives` holds the four collectives along one axis ('sp' in
`parallel/sp.py`) in one place.  A sum or a max over the axis gathers every
shard's partial and reduces them in shard order, so a solve over W ranks is
the in-process solve bit for bit: an `all_reduce` would reduce in the
backend's order.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from parallel_ddp_tpu_torch.config import CostWeights, SolveOutput, SolverConfig
from parallel_ddp_tpu_torch.costs.base import CostModel
from parallel_ddp_tpu_torch.device import as_tensor
from parallel_ddp_tpu_torch.models.base import Plant
from parallel_ddp_tpu_torch.solver import make_ilqr_solver


def _world() -> tuple:
    """(ranks, this rank) of the default process group; (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _box(shape: tuple, first: int, count: int) -> tuple:
    """The shards first .. first+count-1 of a row-major mesh as a box:
    ((start, size) per axis), or ValueError if they do not form one."""
    sizes, rem = [], count
    for s in reversed(shape):
        if rem >= s:
            if rem % s:
                raise ValueError(f"{count} shards a rank do not tile a mesh of shape {shape}")
            sizes.append(s)
            rem //= s
        else:
            if s % rem:
                raise ValueError(f"{count} shards a rank do not tile a mesh of shape {shape}")
            sizes.append(rem)
            rem = 1
    sizes.reverse()
    starts, flat = [], first
    for s in reversed(shape):
        starts.append(flat % s)
        flat //= s
    starts.reverse()
    return tuple(zip(starts, sizes))


class Mesh:
    """Named axes over shards (see the module docstring).  `shape` maps each
    axis name to its size in axis order, as `jax.sharding.Mesh.shape` does;
    `size` is the number of shards.  With a process group (made before the
    mesh), every rank makes the same meshes in the same order: a mesh makes
    the process groups of its axes."""

    def __init__(self, shape, axis_names):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"a mesh needs one distinct name per axis: {shape}, {axis_names}")
        if any(s < 1 for s in shape):
            raise ValueError(f"mesh axes must have at least one shard: {shape}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.size = math.prod(shape)
        self.ranks, self.rank = _world()
        if self.size % self.ranks:
            raise ValueError(f"{self.ranks} ranks do not divide the mesh's {self.size} shards")
        per = self.size // self.ranks
        self._boxes = [_box(shape, r * per, per) for r in range(self.ranks)]
        self._groups = {}
        if self.ranks > 1:
            for i, axis in enumerate(axis_names):
                self._groups[axis] = self._axis_group(i)

    def _axis_group(self, i: int):
        """The process group of the ranks whose shards differ from this
        rank's along axis i only (None if this rank holds the whole axis).
        Every rank makes every such group of the axis, in one order."""
        key = lambda r: tuple(b for j, b in enumerate(self._boxes[r]) if j != i)
        mine = None
        for k in sorted({key(r) for r in range(self.ranks)}):
            members = [r for r in range(self.ranks) if key(r) == k]
            if len(members) == 1:
                group = None
            elif len(members) == self.ranks:
                group = dist.group.WORLD
            else:
                group = dist.new_group(members)
            if self.rank in members:
                mine = group
        return mine

    def local(self, axis: str) -> tuple:
        """(first shard, shards) of this rank along `axis`."""
        return self._boxes[self.rank][self.axis_names.index(axis)]

    def group(self, axis: str):
        """The process group of `axis` (None: this rank holds all of it)."""
        return self._groups.get(axis)


def make_mesh(n_devices: Optional[int] = None, axis_names=("dp",)) -> Mesh:
    """A mesh of n_devices shards along its first axis, every other axis of
    size 1 (the reference's `make_mesh`).  n_devices defaults to the
    process group's size (1 without one): one shard a rank, a rank a card."""
    n = _world()[0] if n_devices is None else int(n_devices)
    return Mesh((n,) + (1,) * (len(axis_names) - 1), axis_names)


class Collectives:
    """The collectives along one axis of a mesh, on tensors that hold this
    rank's shards of the axis as their dim `dim` (all of them in one
    process): `lax.ppermute` from the right neighbour, `psum`, `pmax` and
    `all_gather` of the reference's `shard_map` bodies.  `size` is the
    axis's shard count, `first` and `count` this rank's shards."""

    def __init__(self, mesh: Mesh, axis: str):
        self.size = mesh.shape[axis]
        self.first, self.count = mesh.local(axis)
        self.group = mesh.group(axis)
        self.parts = self.size // self.count        # ranks along the axis

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every shard's slice of t along dim, in shard order (also
        `scatter`'s inverse)."""
        if self.group is None:
            return t
        wire = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
        parts = [torch.empty_like(wire) for _ in range(self.parts)]
        dist.all_gather(parts, wire, group=self.group)
        out = torch.cat(parts, dim=dim)
        return out.to(torch.bool) if t.dtype == torch.bool else out

    def from_right(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Each shard receives its right neighbour's slice (shard i <- i+1),
        the last shard zeros."""
        first = t.narrow(dim, 0, 1)
        if self.group is None:
            right = torch.zeros_like(first)
        else:
            heads = self.all_gather(first, dim)
            nxt = self.first // self.count + 1
            right = heads.narrow(dim, nxt, 1) if nxt < self.parts else torch.zeros_like(first)
        return torch.cat([t.narrow(dim, 1, self.count - 1), right], dim=dim)

    def _fold(self, op, t: torch.Tensor, dim: int) -> torch.Tensor:
        every = self.all_gather(t, dim)
        acc = every.select(dim, 0)
        for i in range(1, self.size):
            acc = op(acc, every.select(dim, i))
        return acc

    def psum(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The sum over the axis, in shard order; dim is reduced."""
        return self._fold(torch.add, t, dim)

    def pmax(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The max over the axis (NaN wins); dim is reduced."""
        return self._fold(torch.maximum, t, dim)

    def any(self, flag: torch.Tensor, dim: int) -> torch.Tensor:
        """The logical or over the axis; dim is reduced."""
        return self.all_gather(flag, dim).any(dim)

    def scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's part of a tensor whose dim spans the whole axis."""
        if self.group is None:
            return t
        per = t.shape[dim] // self.size
        return t.narrow(dim, self.first * per, self.count * per)


def scatter_batch(comm: Collectives, x0s, u0s, goals) -> tuple:
    """This rank's scenarios of a batch (x0s, u0s and the goals' tensors,
    each with a leading B) along the scenario axis of `comm`."""
    part = lambda t: comm.scatter(t, 0) if isinstance(t, torch.Tensor) else t
    return part(x0s), part(u0s), pytree.tree_map(part, goals)


def _check_mesh(mesh) -> None:
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.sharding.Mesh, got {type(mesh).__name__}")


def make_batched_solver(
    plant: Plant,
    cost: CostModel,
    cfg: SolverConfig,
    mesh: Optional[Mesh] = None,
    batch_axis: str = "dp",
    initial_rollout: bool = True,
):
    """Return solve_batch(x0s, u0s, goals, weights=None) -> SolveOutput.

    x0s: (B, N, n), u0s: (B, N, m), goals: a pytree with a leading B on each
    tensor leaf; the weights and the iteration cap (cfg.max_iter) are shared.
    Every scenario is an independent solve (the reference's
    `jax.vmap(solver)`): each commits under its own ~done & (it <= cap) and
    the batch runs while any scenario is active.  Each leaf of the output
    has a leading B.  With a `Mesh`, B must divide by its `batch_axis` size
    (ValueError); in one process the whole batch is one solve, and over a
    process group each rank solves its slice of the scenarios and every rank
    gets the gathered outputs.  `solve_batch.solver` is the solver (its
    `graphs` and `host_syncs`)."""
    if mesh is not None:
        _check_mesh(mesh)
    solver = make_ilqr_solver(plant, cost, cfg)
    comm = None if mesh is None else Collectives(mesh, batch_axis)

    def solve_batch(x0s, u0s, goals, weights: Optional[CostWeights] = None):
        if comm is not None and len(x0s) % comm.size:
            raise ValueError(f"batch {len(x0s)} not divisible by the '{batch_axis}' axis size "
                             f"{comm.size}")
        if comm is None or comm.group is None:
            return solver.solve_batch(x0s, u0s, goals, weights, initial_rollout=initial_rollout)
        out = solver.solve_batch(*scatter_batch(comm, as_tensor(x0s), as_tensor(u0s), goals),
                                 weights, initial_rollout=initial_rollout)
        return SolveOutput(*(comm.all_gather(t, 0) for t in out))

    solve_batch.solver = solver
    return solve_batch
