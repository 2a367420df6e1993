"""Carry the JAX reference package's parameters and state into this package.

Each function takes an object of `parallel_ddp_tpu` and returns this
package's counterpart, passing every value through `np.asarray`, so this
module never imports jax: it works on whatever the caller hands it.  The
parity tests use it so that both packages compute on identical inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from parallel_ddp_tpu_torch.config import CostWeights, SolverConfig
from parallel_ddp_tpu_torch.models.kuka import soa
from parallel_ddp_tpu_torch.models.kuka.model import KukaParams


def tensor(a, device=None, dtype=None) -> torch.Tensor:
    """A reference array (or numpy array / number) as a tensor that owns its
    memory."""
    return torch.as_tensor(np.array(np.asarray(a)), device=device, dtype=dtype)


def solver_config(cfg) -> SolverConfig:
    """The reference's `SolverConfig` (same field names and meanings)."""
    return SolverConfig(**dataclasses.asdict(cfg))


def cost_weights(w) -> CostWeights:
    """The reference's `CostWeights` NamedTuple, as plain floats."""
    return CostWeights(**{k: float(np.asarray(v)) for k, v in w._asdict().items()})


def goal(g, device=None) -> dict:
    """The reference's goal dict ({"ee_goal", "x_target", ...})."""
    return {k: tensor(v, device=device) for k, v in g.items()}


def warm_start(out, device=None) -> dict:
    """Warm-start keyword arguments (x0, u0, P0, p0, d0) for this package's
    solve, from a reference `SolveOutput`."""
    return {
        "x0": tensor(out.x, device),
        "u0": tensor(out.u, device),
        "P0": tensor(out.P, device),
        "p0": tensor(out.p, device),
        "d0": tensor(out.d, device),
    }


def kuka_params(params) -> KukaParams:
    """The reference's `KukaParams`: core "pallas" maps to "cuda" (the kernel
    hooks), every other core to "soa"."""
    core = "cuda" if params.core == "pallas" else "soa"
    return KukaParams(ee_type=params.ee_type, gravity=float(params.gravity), core=core)


def kuka_constants(cc) -> soa._Consts:
    """The reference's scalar-channel chain constants (`soa._Consts`)."""
    return soa._Consts(
        np.asarray(cc.r_tree), np.asarray(cc.p_tree), np.asarray(cc.i_spatial),
        np.asarray(cc.ee_offset), float(cc.gravity),
        joint_types=cc.joint_types,
        ee_rot=None if cc.ee_rot is None else np.asarray(cc.ee_rot),
    )
