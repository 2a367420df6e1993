"""Trajectory / solver-state checkpointing (twin of
`parallel_ddp_tpu/utils/checkpoint.py`).

The reference has no file checkpointing; its persistence analog is the
warm-start state (x, u, KT, P, p, d) kept device-resident across MPC solves
and the serialized `lcmt_trajectory` messages exchanged between processes
(SURVEY.md §5 checkpoint/resume).  This module adds the file form: save/load
an MPCState or SolveOutput as a single .npz so a controller can resume a
warm-started loop across process restarts.  The field names and dtypes are
the JAX package's, so a file written by either package loads in the other.
Loading puts the tensors on `device` (default: the card).
"""

from __future__ import annotations

import numpy as np
import torch

from parallel_ddp_tpu_torch.device import as_tensor
from parallel_ddp_tpu_torch.mpc.driver import MPCState

_MPC_FIELDS = ("x", "u", "K", "P", "p", "d", "t0", "fails")
_WARM_FIELDS = ("x", "u", "K", "P", "p", "d")
_SOLUTION_FIELDS = ("x", "u", "K", "P", "p", "d", "J", "J_trace", "alpha_trace")


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def save_mpc_state(path: str, st: MPCState) -> None:
    np.savez_compressed(path, **{f: _host(getattr(st, f)) for f in _MPC_FIELDS})


def load_mpc_state(path: str, device=None) -> MPCState:
    with np.load(path) as data:
        return MPCState(*(as_tensor(data[f], device=device) for f in _MPC_FIELDS))


def save_solution(path: str, out) -> None:
    """Persist a SolveOutput (x, u, K and traces) as .npz."""
    np.savez_compressed(path, **{f: _host(getattr(out, f)) for f in _SOLUTION_FIELDS})


def load_warm_start(path: str, device=None) -> dict:
    """Load (x, u, K, P, p, d) suitable for warm-starting a solve."""
    with np.load(path) as data:
        return {k: as_tensor(data[k], device=device) for k in _WARM_FIELDS}
