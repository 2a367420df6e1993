"""Tracing / profiling utilities (twin of `parallel_ddp_tpu/utils/profiling.py`;
SURVEY.md §5).

The reference records wall-clock deltas around each solver phase into output
arrays (DDPWrappers.cuh:23,54-105) and aggregates them into median/avg/std/
min/max tables (WAFR_iLQR_examples.cu:122-227); online it appends per-solve
(J, alpha, timings) into an `algTrace` struct (MPCHelpers.cuh:51-56).

Here the production solve is ONE CUDA graph (no phase boundaries to time),
so profiling is explicit:

  * `phase_times` runs each phase of an iteration on its own and times it:
    with CUDA events on the card, the host clock on the CPU;
  * `timing_stats` is the median/avg/std/min/max aggregator;
  * `AlgTrace` collects per-solve (J, iters, alpha trace, wall time) series
    from repeated solves or MPC steps — the `algTrace` analog.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from parallel_ddp_tpu_torch.config import weights_tensor
from parallel_ddp_tpu_torch.device import as_tensor
from parallel_ddp_tpu_torch.parallel.backward import backward_pass
from parallel_ddp_tpu_torch.parallel.forward import forward_pass
from parallel_ddp_tpu_torch.solver import _derivatives, make_ilqr_solver, refuse_tf32


def timing_stats(samples_s) -> Dict[str, float]:
    """median/avg/std/min/max in milliseconds (printAllTimingStats analog)."""
    a = np.asarray(samples_s) * 1e3
    return {
        "median_ms": float(np.median(a)),
        "avg_ms": float(np.mean(a)),
        "std_ms": float(np.std(a)),
        "min_ms": float(np.min(a)),
        "max_ms": float(np.max(a)),
    }


def _time_fn(fn: Callable, device: torch.device, reps: int, warmup: int = 3) -> List[float]:
    """Seconds of each of `reps` calls of fn: CUDA events around each call on
    the card (the stream drained before it), the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    ts = []
    if device.type == "cuda":
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) * 1e-3)
        return ts
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return ts


def phase_times(plant, cost, cfg, x, u, goal, weights=None, reps: int = 20, device=None):
    """Per-phase timing table for one solver configuration.

    Runs the derivative recompute (nextIterationSetup), the backward pass
    and the forward pass (sweep + rollout + cost/defect) each on its own on
    the device of x (a tensor keeps its device; anything else goes to
    `device`, default the card) and times each; returns {phase:
    timing_stats}.  Mirrors the reference's bpTime/sweepTime/simTime/nisTime
    breakdown (DDPWrappers.cuh:54-105)."""
    x = as_tensor(x, dtype=torch.float32, device=device)
    dev = x.device
    u = as_tensor(u, dtype=torch.float32, device=dev)
    refuse_tf32(dev)
    solver = make_ilqr_solver(plant, cost, cfg)
    w = weights_tensor(weights, dev)
    n, N = plant.n_state, cfg.num_time_steps
    alphas = solver.alphas(dev, torch.float32)
    stage = lambda xk, uk, k: solver.stage(xk, uk, k, goal, w)

    out: Dict[str, Dict[str, float]] = {}
    derivs = lambda: _derivatives(cfg, solver.step_jac, cost.quad, x, u, goal, w)
    AB, H, g = derivs()
    out["next_iter_setup"] = timing_stats(_time_fn(derivs, dev, reps))

    zeros_n = x.new_zeros((N, n))
    zeros_nn = x.new_zeros((N, n, n))
    rho = torch.full((), cfg.rho_init, device=dev)
    drho = torch.full((), 1.0, device=dev)
    bp = lambda: backward_pass(cfg, AB, H, g, zeros_nn, zeros_n, zeros_n, x, x, rho, drho)
    bp_out = bp()
    out["backward_pass"] = timing_stats(_time_fn(bp, dev, reps))

    fp = lambda: forward_pass(cfg, solver.step_fwd, stage, x, u, zeros_n, bp_out.K, bp_out.du,
                              bp_out.ApBK, bp_out.Bdu, x, alphas, fused_sim=solver.fused_sim)
    out["forward_pass"] = timing_stats(_time_fn(fp, dev, reps))
    return out


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@dataclasses.dataclass
class AlgTrace:
    """Per-solve series collector (the reference's algTrace, MPCHelpers.cuh:51-56)."""

    J: List[float] = dataclasses.field(default_factory=list)
    iters: List[int] = dataclasses.field(default_factory=list)
    alpha_idx: List[int] = dataclasses.field(default_factory=list)
    wall_s: List[float] = dataclasses.field(default_factory=list)
    accepted: List[bool] = dataclasses.field(default_factory=list)

    def record_solve(self, out, wall_s: Optional[float] = None):
        """Append one SolveOutput."""
        self.J.append(float(out.J))
        self.iters.append(int(out.iters))
        at = _host(out.alpha_trace)
        good = at[at >= 0]
        self.alpha_idx.append(int(good[-1]) if good.size else -1)
        if wall_s is not None:
            self.wall_s.append(wall_s)

    def record_mpc(self, info, wall_s: Optional[float] = None):
        """Append one MPCStepInfo."""
        self.J.append(float(info.J))
        self.iters.append(int(info.iters))
        self.accepted.append(bool(info.accepted))
        if wall_s is not None:
            self.wall_s.append(wall_s)

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if self.wall_s:
            out["solve"] = timing_stats(self.wall_s)
        if self.J:
            out["J_final_median"] = float(np.median(self.J))
            out["iters_median"] = float(np.median(self.iters))
        if self.accepted:
            out["accept_rate"] = float(np.mean(self.accepted))
        return out
