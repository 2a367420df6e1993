"""Trajectory-runner control computation (getHardwareControls, MPCHelpers.cuh:817-858).

A copy of `parallel_ddp_tpu/mpc/controls.py`: host-side numpy on purpose,
in both packages.  This runs in the kHz control loop between solver
updates — latency matters more than throughput, and it must not contend with
the device.  A C++ implementation lives in native/ for the real-time path.
The on-device twin is `mpc/device_loop.py::get_hardware_controls`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class TrajHandoff(NamedTuple):
    """The solver->runner contract (the reference's trajVars / lcmt_trajectory,
    MPCHelpers.cuh:58-66, lcmtypes)."""

    x: np.ndarray    # (N, n_state)
    u: np.ndarray    # (N, n_ctrl)
    K: np.ndarray    # (N, n_ctrl, n_state)
    t0: float        # plant time of x[0]
    dt: float


def get_hardware_controls(
    traj: TrajHandoff,
    t_now: float,
    x_meas: np.ndarray,
    use_feedback: bool = True,
    u_prev: Optional[np.ndarray] = None,
    smoothing: float = 0.0,
):
    """u_out = u_k - K_k (x_meas - x_ref), FOH on x, ZOH on u and K.

    Returns (u_out, ok).  ok=False when t_now indexes past the usable end of
    the trajectory — the runner must fail loudly (MPCHelpers.cuh:827)."""
    n = traj.x.shape[0]
    rel = (t_now - traj.t0) / traj.dt
    ind = int(np.floor(rel))
    frac = rel - ind
    if ind < 0 or ind >= n - 1:
        return np.zeros(traj.u.shape[1], traj.u.dtype), False
    if use_feedback:
        x_ref = (1.0 - frac) * traj.x[ind] + frac * traj.x[ind + 1]
        u_out = traj.u[ind] - traj.K[ind] @ (x_meas - x_ref)
    else:
        u_out = traj.u[ind].copy()
    if u_prev is not None and smoothing > 0.0:
        u_out = (1.0 - smoothing) * u_out + smoothing * u_prev
    return u_out, True
