#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (`parallel_ddp_tpu_torch`) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero):
  1. device  — a CUDA device is required (there is no CPU fallback); prints
               the card's name and power limit as nvidia-smi reports them.
  2. build   — compiles the CUDA kernels of `parallel_ddp_tpu_torch/csrc`;
               prints ptxas's registers and spills of each, and fails where
               the forward-dynamics kernels (qdd, chain) spill.
  3. kernels — each kernel against its plain PyTorch version on the card, on
               seeded inputs at the main path's shapes, within a stated
               tolerance; each one's time against the plain version's and
               against its roofline bound (the forward-dynamics kernel at
               B = 1 and at B = 8192, the batched dynamics benchmark's; the
               RBD-Jacobian kernel also through its Euler epilogue, the
               discrete AB, against the composer on the plain Jacobian; the
               rollout kernel Euler and RK3; the simulation chain open loop
               at T = 63 Euler, 4 x 16 Euler, T = 15 RK3, 256 chains of 63
               (the fleet warm start) and 1,024 of 16 (the batched cold
               rollout), and its runner mode, 10 substeps under a seeded
               plan, each with its kernel alone, us a step and bound, and
               each Euler chain also on its in-step schedule, which it must
               equal bit for bit; the Riccati sweep at the Kuka's sizes, on blocks of
               96 steps, longer than its ring of staged steps, and at n = 4,
               m = 2, the run-time-size body, and at every shape a path of
               the plants, urdf and constraints phases gives it, from the
               configs those phases solve with: (n, m) = (2, 1), (4, 1),
               (12, 4) over 4 lanes of 32 steps, (14, 7) and (12, 4) over 4
               lanes of 16, (2, 1) over 2 lanes of 16 and over 2 lanes of
               24, each timed beside its bound); the Kuka kernels
               also at gravity 9.81 (kuka_joint's) and
               the forward dynamics at kuka_joint's FD batch of 2,646 samples;
               the RBD-Jacobian kernel (Jacobian and qdd, gravity 0 and 9.81)
               and the forward-dynamics kernel also against the independent
               spatial-algebra core (`models/kuka/rbd.py` KukaRBD) on the
               card, at the JAX package's bounds for its two cores;
               the wrappers' host cost per enqueue apart from the kernels' own
               time (CUDA-graph replay; the forward dynamics at every B).
  4. solve   — the WAFR Kuka iiwa-14 end-effector solve (N=64, 4+4 blocks,
               16 alphas, Euler, gravity-compensated) with the fused Riccati
               sweep, cold then three warm re-solves along the figure-8 goal,
               each one replay of a CUDA graph (`parallel_ddp_tpu_torch/
               graphs.py`: the iterations and the rho retry are WHILE nodes);
               every kernel must have launched during them (counted on the
               device, under replay); the cold and the first warm solve are
               repeated on CPU tensors (plain versions, host loops) and the
               traces must agree.
  5. timing  — median of 20 replayed warm 6-iteration re-solves (the first
               warm re-solve, repeated; CUDA events); the solver's host reads
               and torch's sync-debug count of one solve must both be 0.
  5b. plants — the WAFR example's other four problems at their presets'
               full sizes with the fused Riccati sweep (pendulum, cart-pole,
               quadrotor: N = 128, 4 blocks, RK3, no kernel hooks, their
               step and jacfwd captured op by op; kuka_joint: N = 64, Euler,
               gravity on, through the Jacobian, rollout and chain kernels),
               from the JAX package's own start states and goals: each cold
               solve one graph replay (launch counts zeroed just before it;
               0 host reads) against the same solve on CPU tensors (alphas
               equal up to the CPU trace's first near tie, J within
               SOLVE_RTOL) and the JAX tests' convergence bars; a warm
               6-iteration re-solve timed (median of 20, CUDA events) with
               its iteration body's graph nodes; kuka_joint with finite
               differences (the FD AB through one qdd launch of 2,646
               samples against the CPU's FD AB and the Jacobian kernel's AB,
               at tests/test_torch_plants.py's bounds; the FD solve card
               against CPU within FD_ENVELOPE_FACTOR x the gap that moving
               the start by one or two ulps makes on the CPU); the
               pendulum's device closed loop of
               tests/test_mpc.py (30 control steps, 3 on CPU tensors).
  5b'. urdf — the URDF front end (`parallel_ddp_tpu_torch/models/urdf.py`):
               the packaged iiwa14.urdf parsed and held to the Kuka
               constants at tests/test_urdf.py's bounds; its spatial-algebra
               core's qdd and vmapped-jacfwd Euler AB on the card against the
               same calls on CPU tensors (63 samples); the WAFR-shape URDF
               solve (N = 64, 4 + 4 blocks, 16 alphas, Euler, gravity 0, the
               EE cost, the "auto" = spatial-algebra core, the fused Riccati
               sweep its one kernel) from the goldens' seeded start, cold as
               one replay (launches counted, 0 host reads) against the CPU's
               solve by the plants phase's rule, then a warm 6-iteration
               re-solve timed (median of 20) with its graph's nodes and
               capture seconds, beside the kernel-backed Kuka's.
  5c. constraints — box constraints (`parallel_ddp_tpu_torch/
               constraints.py`) at the WAFR width, each path with its own
               launch counts: the torque-limited WAFR Kuka EE solve of
               tests/test_constraints.py:110-131 at N = 64 (|u_i| <= 40 Nm,
               6 outer x at most 40 inner iterations through
               `make_al_solver`: one replay an inner solve, one host read an
               outer iteration and one for base_J), from the goal moved by
               -10..10 ulps, held to the JAX package's own readings over
               the same goals (the test's violation bar holds at N = 16
               only), its first outer solve against CPU tensors (8
               iterations), the inner replays timed; a constrained batched WAFR solve at
               B = 256 (6 iterations, lam scaled per scenario; scenarios 0,
               128 and 255 against their single solves by the batched
               phase's rule); the pendulum constrained MPC closed loop of
               tests/test_constraints.py:63-107 (200 periods at 50 Hz, one
               `ALMPCController` replay each, two 100 Hz RK3 plant steps of
               the clipped command, 0 host reads), held to that test's bars,
               its first 3 periods against CPU tensors, a period timed.
  6. fig8    — the figure-8 closed loop of benchmarks/fig8.py through the
               port's MPC controller and device loop, one graph replay per
               control step: cold start (one replay of the 50-iteration
               solve's graph), a 4 s settle on the path's start, then the
               whole 10 s track at 100 Hz (6-iteration warm solves, 1 kHz
               Euler plant); each of its kernels (all but the single-
               evaluation forward dynamics) must have launched during it;
               the average EE error must be finite and at most the original
               CUDA implementation's 0.0878 m; host reads per control step
               must be 0.  Three control steps from the settled state are
               repeated on CPU tensors (plain versions) and must agree with
               the GPU's (torch's sync-debug count of the GPU's: 0), as must
               three steps of the block re-rollout warm start
               (full_rollout=False), a path of its own with its own launch
               counts, on which every kernel must have launched (its
               boundary defects are single forward-dynamics evaluations);
               the chain's trajectory-runner mode is held against its plain
               version from the settled state; the stages of one control
               step are timed eagerly (derivative stage, backward pass,
               forward pass and their pieces), the warm start and the
               substeps also the way they ran before the chain kernel (one
               forward-dynamics launch per step).
  7. profile — back-to-back replayed warm solves and fig-8 control steps:
               the stream's time a call (CUDA events) against the host's, and
               the mean time of a graph node; then one torch.profiler run of
               each: kernels run on the card, graph launches, stream syncs,
               device time and busy share as the profiler sees them.
  8. batched — scenario batching (parallel/sharding.py, the fleet MPC step):
               the batched rollout and Riccati kernels at B = 256 against
               their plain versions and, bit for bit, against one launch per
               scenario for scenarios 0, 1, 128 and 255; those two and the
               Jacobian kernel timed at B = 256, 1024 and 4096 beside the
               roofline bound of each B; the Jacobian (and Euler AB) and
               chain kernels at each B's flattened sizes against their plain
               versions; a batched WAFR solve at B = 256 (scenario b's goal
               the figure-8 at 10 s * b / B, from the cold solve's
               trajectory, the config's own tol_cost, at most 40 iterations)
               against the sampled scenarios solved alone (J traces within
               a one-ulp rounding envelope; B copies of a scenario and a
               batch of 1 bit for bit), with 0 host reads and 0 sync-debug
               syncs; the launches of a batched
               6-iteration solve, which must not depend on B; batched
               solves/s at B = 256, 1024 and 4096 (tol_cost = 0, CUDA events
               around 10 replays) with each graph's nodes, pool and capture
               time and the stream's busy share, and the stages of one
               batched iteration at B = 1024; `init_state_batch` and
               `step_batch` at B = 256 from the settled fig-8 state (scenario
               0 against a single step; 0 host syncs); the fig-8 control step
               replayed with changed weights (no new capture, a new J); and a
               B = 2 batch from the solve phase's cold start on CPU tensors
               against the card, and on the fig-8 inputs beside a single
               solve's GPU-to-CPU gap.
  9. graphs  — every graph captured: seconds to capture and instantiate,
               nodes (WHILE bodies included) and the bytes its memory pool
               holds.
Then one JSON line with every kernel's numbers, the card line, and last
{"ok": true, "device": {...}}.  Takes 3 to 4 minutes on an H100.
`python3 chip_smoke.py --kernels-only` stops after phase 3 and prints no
result line: a short run while working on a kernel.

Imports torch, numpy and the port only (never jax).
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import time
import warnings

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N_ITERS = 6          # iterations per solve (fixed budget: tol_cost = 0)
QDD_BATCHES = (1, 8192)  # forward dynamics: the closed loop's and timedyn's batch
GRAVITY = 9.81       # kuka_joint's arm has gravity on (not gravity-compensated)
# the finite-difference step Jacobian of kuka_joint: 2 (14 + 7) perturbed
# copies of the 63 samples, one forward-dynamics launch (Euler)
QDD_FD_BATCH = 2 * 21 * 63
N_WARM = 3           # warm re-solves along the figure-8 after the cold solve
N_TIMED = 20         # warm solves in the timing median
MPC_DT = 0.01        # figure-8 goal step between re-solves (100 Hz replanning)

# Kernel vs plain version on the card, both float32 on the same inputs.  The
# two compute the same formulas in another order: nvcc contracts a*b+c into
# fused multiply-adds and sums in its own order, while the plain versions run
# PyTorch's separate kernels (and PyTorch's forward-mode AD rules for the
# Jacobian).  Allowed: |kernel - plain| <= RTOL*|plain| + ATOL*max|plain|.
TOL = {
    # ~2k-operation chain ending in a Cholesky solve of the 7x7 mass matrix,
    # whose condition number (~1e3) amplifies float32 rounding (~1e-7)
    "rbd_jac": (1e-3, 1e-4),
    # 16 dependent integration steps with state feedback: rounding compounds
    "rollout": (1e-4, 1e-5),
    # 16 dependent Riccati steps of 14x21 products and a 7x7 Cholesky
    "riccati": (1e-4, 1e-5),
    # the ~2k-operation chain of rbd_jac's primal, ending in the same
    # Cholesky solve (cond(M) ~1e3 amplifies float32 rounding)
    "qdd": (1e-3, 1e-4),
    # up to 63 dependent integration steps in one thread: measured 2.1e-6
    # (max |x| ~ 7) at T = 63 Euler on an H100; rounding compounds per step
    "sim_chain": (1e-5, 2e-6),
}
# the card's published peaks (NVIDIA H100 SXM data sheet): HBM3 bytes/s and
# float32 operations/s outside the tensor cores (the kernels' arithmetic)
H100_BYTES_PER_S = 3.35e12
H100_FP32_PER_S = 67e12
# GPU (kernels) vs CPU (plain versions) solve: the same accept/reject and
# alpha decisions, and J within this relative tolerance (float32 rounding of
# two different summation orders over 6 iterations of a chaotic problem)
SOLVE_RTOL = 1e-3

# fig-8 closed loop (benchmarks/fig8.py): 100 Hz control, 1 kHz Euler plant,
# a 4 s settle on the path's start, then the 10 s figure-8
FIG8_PERIOD = 0.01
FIG8_SIM_HZ = 1000.0
FIG8_SETTLE_S = 4.0
FIG8_TRACK_S = 10.0
FIG8_CHUNK = 100          # control steps between synced, timed reads
FIG8_BUDGET_S = 600.0     # the track is shortened (and says so) past this
FIG8_BAR_M = 0.0878       # the original CUDA implementation's average EE error
# GPU vs CPU over 3 control steps from the settled state: the same accept
# decisions, J within SOLVE_RTOL, the EE error within this many metres
# (float32 rounding of two summation orders through 3 solves and 30 substeps)
FIG8_CPU_STEPS = 3
FIG8_ERR_ATOL = 1e-4
# forward-dynamics-family launches (qdd + chain) allowed per control step
FIG8_QDD_FAMILY_MAX = 3
# scenario batching: the batch the checks run at, the scenarios held against
# their own launches and solves, the batches timed, replays a timing
BATCH_CHECK = 256
BATCH_SAMPLES = (0, 1, 128, 255)
BATCH_SIZES = (256, 1024, 4096)
BATCH_TIMED = 10
BATCH_STAGES = 1024           # the batch whose iteration is timed stage by stage
# the correctness batch's iteration cap: the batched body's glue (cost H/g,
# sweep, sums) runs at another batch size than a single solve's, so its
# float32 rounding differs and a long solve's near-tie alphas part (measured:
# scenario 0 at iteration 67 of 100); a cut of depth, the tol_cost is the
# config's own
BATCH_CHECK_ITERS = 40
BATCH_CPU_ITERS = 3           # the B = 2 batch held against CPU tensors: its cap
# a sampled scenario's J trace against its single solve, iteration by
# iteration: within J_TRACE_FACTOR x the running largest gap that a one-ulp
# move of the initial controls makes along the single solve's own trace (the
# rounding envelope), and never held tighter than J_TRACE_FLOOR (measured on
# an H100: at most 2.29 x, the same in two runs)
J_TRACE_FACTOR = 10.0
J_TRACE_FLOOR = 1e-6
# the B = 2 batch on the fig-8 inputs: its GPU-to-CPU gap at most this many
# times a single solve's on the same scenario, iteration by iteration
# (measured: 1.8e-3 and 1.7e-3 after 3 iterations on an H100)
FIG8_OWN_GAP = 2.0
GAP_AT = (0, 1, 2, 3, 5, 10, 20, 30, 40)   # the iterations a gap is printed at
# plants phase (the WAFR example's other four problems at full size).  The
# card's solve (kernels, cuBLAS) and the CPU's (plain versions) round
# differently, by about SOLVE_RTOL of J; a decision can flip only where the
# solve meets a near tie at that level: a rejected step, or an accepted one
# that gains less than PLANT_TIE of J.  Up to the CPU trace's first near tie
# the alphas must be equal and J within SOLVE_RTOL; after a parting the two
# solves must end within PLANT_FINAL_RTOL of each other.  The FD solve's
# Jacobians carry ~ulp / eps ~ 1e-3 of noise or more: its near tie is at
# 10x that.
PLANT_TIE = SOLVE_RTOL
PLANT_FD_TIE = 1e-2
PLANT_FINAL_RTOL = 1e-2
# the Kuka's CPU solves run the plain versions at ~0.9 s an iteration on the
# card's host: the CPU check of kuka_joint's cold solves is capped (a prefix
# of the same solve; the card's runs the whole cap)
PLANT_CPU_ITERS = {"kuka_joint": 8}
# the FD AB against an AD-exact AB: rounding of the two steps over 2 eps,
# this many ulps of max|x'| (tests/test_torch_plants.py's FD-vs-AD bound)
FD_ROUNDING_ULPS = 8
# the FD solves amplify that rounding (a one-ulp move of the start moves the
# Kuka's FD solve by percents of J within two iterations): the CPU's FD
# solve from the start moved by each of ULP_MOVES float32 ulps gives the
# rounding envelope, and the card's FD solve must stay within
# FD_ENVELOPE_FACTOR x it.  The JAX package's FD solve, a third rounding,
# stays within 0.53 x the same envelope at N = 16 (tests/test_torch_plant_solves.py,
# test_kuka_finite_difference_solve_parts_within_rounding)
ULP_MOVES = (1, -1, 2, -2)
FD_ENVELOPE_FACTOR = 2.0
# the pendulum's closed loop (tests/test_mpc.py:116-135) and its CPU check
PEND_LOOP_STEPS = 30
PEND_CPU_STEPS = 3
PEND_X_ATOL = 1e-4
# constraints phase (parallel_ddp_tpu_torch/constraints.py), at the WAFR
# width: tests/test_constraints.py:110-131's torque-limited Kuka EE solve
# (|u_i| <= 40 Nm, 6 outer iterations of at most 40 inner ones, from zeros
# toward (0.3, -0.3, 0.9)) at N = 64 in place of N = 16; its first outer
# solve on CPU tensors, capped as kuka_joint's is
AL_U_MAX = 40.0
AL_GOAL = [0.3, -0.3, 0.9]
AL_MAX_OUTER = 6
AL_MAX_ITER = 40
AL_U_BAR = AL_U_MAX * 1.001
AL_VIOL_BAR = 2e-3
AL_START_ERR = 0.595           # the straight-up home EE's distance to AL_GOAL
AL_EE_GAIN = 0.1
# At N = 64 the JAX package's own solve misses the test's violation bar
# (set at N = 16), and its reading is no stable number: the outer loop's
# path parts at near ties, so moving the goal by a few ulps moves the last
# violation by an order of magnitude.  So the solve runs from the goal moved
# by -AL_ULPS..AL_ULPS float32 ulps, and is held as the JAX package reads
# the same goals (scripts/jax_torque_limited_n64.py, on a CPU): every EE
# error within the test's bar, as every JAX reading is; the median of the
# last violations and of max|u| at most the JAX readings' upper quartile.
# The JAX package's 21 readings: last violation 2.117e-3 to 0.1065, median
# 2.361e-3, none below 2e-3; max|u| 40.0021 to 40.1065 (one above the
# test's 40.04); EE error 0.3233 to 0.3252 m
AL_ULPS = 10
AL_JAX_Q3 = {"last_violation": 7.778e-3, "max_abs_u": 40.00778}
AL_CPU_ITERS = PLANT_CPU_ITERS["kuka_joint"]
# the constrained batched WAFR solve: scenario b's multipliers are the
# torque-limited solve's times b / (B - 1); the batched phase's rule
AL_BATCH = 256
AL_BATCH_SAMPLES = (0, 128, 255)
# tests/test_constraints.py:63-107's constrained pendulum MPC: |u| <= 6,
# mu 50, 200 periods at 50 Hz, two 100 Hz RK3 plant steps of the clipped
# command each; its bars
AL_PEND_U_MAX = 6.0
AL_PEND_MU = 50.0
AL_PEND_PERIODS = 200
AL_PEND_SUBSTEPS = 2
AL_PEND_SIM_DT = 0.01
AL_PEND_BARS = dict(q_err=0.05, qd=0.1, head=AL_PEND_U_MAX * 1.05, tail=AL_PEND_U_MAX * 1.25,
                    plan=AL_PEND_U_MAX + 1e-2)
# urdf phase: the packaged iiwa-14 URDF (parallel_ddp_tpu_torch/models/data)
# at the WAFR shape (N = 64 over 0.5 s, 4 + 4 blocks, 16 alphas, Euler,
# gravity-compensated) on urdf_plant's "auto" core, the spatial-algebra one,
# from the goldens' seeded start (tests/test_torch_golden.py run_case, seed
# 0) toward their goal; its dynamics, AB and cost are PyTorch ops in the
# graph, the fused Riccati sweep its one kernel.  The core on the card
# against the same core on CPU tensors at the derivative stage's 63 samples.
URDF_GOAL = [0.3, -0.5, 0.4]
URDF_SAMPLES = 63
URDF_MAX_DEFECT = 0.1          # tests/test_urdf.py's bar for a URDF arm's solve
# the kernels against the independent spatial-algebra core (KukaRBD) on the
# card: |kernel - rbd| <= rtol |rbd| + atol, the JAX package's own bounds of
# its scalar-channel core against that core (tests/test_soa.py:35 for qdd,
# :84 for its Jacobian)
RBD_TOL = {"qdd": (2e-4, 2e-2), "rbd_jac": (5e-3, 0.5)}
# the paths driven, each with the launch counters zeroed just before it and
# read just after, and the kernels each must launch
PATH_KERNELS = {
    "wafr_solve": ("rbd_jac", "rollout", "riccati", "sim_chain"),
    "fig8": ("rbd_jac", "rollout", "riccati", "sim_chain"),
    "fig8_block_rerollout": ("rbd_jac", "rollout", "riccati", "qdd", "sim_chain"),
    "wafr_batched": ("rbd_jac", "rollout", "riccati", "sim_chain"),
    "plants_pendulum": ("riccati",),
    "plants_cartpole": ("riccati",),
    "plants_quadrotor": ("riccati",),
    "plants_quadrotor_n64": ("riccati",),
    "plants_kuka_joint": ("rbd_jac", "rollout", "riccati", "sim_chain"),
    "plants_kuka_joint_fd": ("rollout", "riccati", "qdd", "sim_chain"),
    "plants_pendulum_loop": ("riccati",),
    "urdf_iiwa14": ("riccati",),
    "constrained_wafr": ("rbd_jac", "rollout", "riccati", "sim_chain"),
    "constrained_batched": ("rbd_jac", "rollout", "riccati", "sim_chain"),
    "constrained_pendulum_loop": ("riccati",),
}
# the path whose count is a kernel's `launches` in the kernels line: the fig-8
# closed loop, and for the kernel it does not run, the block re-rollout loop
LAUNCHES_FROM = {"rbd_jac": "fig8", "rollout": "fig8", "riccati": "fig8", "sim_chain": "fig8",
                 "qdd": "fig8_block_rerollout"}


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"nvidia-smi: {e}")
    return out.splitlines()[0] if out else "unknown"


def ptxas_summary(log):
    """Registers and spills per kernel, from nvcc's -Xptxas -v output."""
    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '_Z(\d+)(\w+)'", ln)
        if m:
            name, rest = m.group(2)[: int(m.group(1))], m.group(2)[int(m.group(1)):]
            targs = re.match(r"I((?:L[ib]\d+E)+)E", rest)
            if targs:
                name += "<" + ",".join(re.findall(r"L[ib](\d+)E", targs.group(1))) + ">"
        elif name and ("spill" in ln or "registers" in ln or "smem" in ln):
            out.append(f"{name}: {ln.split('info    :')[-1].strip()}")
    return out


def cuda_ms(fn, reps, warmup=2):
    """Mean ms per call of fn on the current stream, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def event_times(fn, reps):
    """ms of each of `reps` calls of fn, by CUDA events around each call
    (the stream drained before it)."""
    import torch

    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def host_and_kernel_us(fn, enqueues, graph_launches=20, replays=10):
    """(host us per enqueue, kernel us per launch) of fn, a wrapper call.
    Host: the host clock around `enqueues` back-to-back calls with no sync
    (what the wrapper costs the Python loop).  Kernel: CUDA events around
    replays of a CUDA graph that captured `graph_launches` calls (no host
    work between the launches; includes the graph's own gap between nodes)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(enqueues):
        fn()
    host_us = (time.perf_counter() - t0) / enqueues * 1e6
    torch.cuda.synchronize()
    from parallel_ddp_tpu_torch.ops import build

    graph = torch.cuda.CUDAGraph()
    with build.uncounted(), torch.cuda.graph(graph):    # no counting node beside the kernel
        for _ in range(graph_launches):
            fn()
    graph.replay()
    kernel_us = cuda_ms(graph.replay, replays, warmup=1) / graph_launches * 1e3
    return host_us, kernel_us


def count_ops(fn):
    """Floating-point operations of one call of fn (a plain PyTorch version,
    which repeats its kernel's arithmetic): every arithmetic aten call it
    dispatches counts one operation per output element, a matrix product two
    per multiply-add."""
    import math

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    pointwise = {"add", "sub", "rsub", "mul", "div", "neg", "sin", "cos", "sqrt", "rsqrt",
                 "reciprocal", "pow", "square", "abs", "addcmul", "addcdiv", "atan2"}

    class Counter(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__.rstrip("_")
            if name in pointwise and isinstance(out, torch.Tensor):
                self.ops += out.numel()
            elif name in ("mm", "bmm", "mv", "dot", "addmm", "baddbmm", "addmv"):
                a = args[-2]            # the left factor: its last dim is contracted
                self.ops += 2 * out.numel() * a.shape[-1]
            elif name in ("sum", "linalg_vector_norm") and isinstance(args[0], torch.Tensor):
                self.ops += args[0].numel()
            return out

    with Counter() as c:
        fn()
    assert math.isfinite(c.ops)
    return c.ops


def roofline(inputs, outputs, ops):
    """bound_ms and what bounds it: each input byte read once and each output
    byte written once over the card's memory rate, against the operations
    over its float32 peak."""
    nbytes = sum(t.numel() * t.element_size() for t in list(inputs) + list(outputs))
    by_bytes = nbytes / H100_BYTES_PER_S * 1e3
    by_ops = ops / H100_FP32_PER_S * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                bytes=nbytes, operations=ops, library_ms=None)


def count_syncs(torch, fn):
    """Run fn with torch's sync debug mode on: (fn's result, the stream
    syncs torch reported during it)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchronizing CUDA operation" in str(w.message) for w in caught)


def profile_line(torch, label, fn):
    """One torch.profiler run of fn: kernels run on the card, kernel and graph
    launches from the host, device time, wall time and the card's busy
    share, printed on one line."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    launches = sum(e.count for e in events if "LaunchKernel" in e.key)
    graph_launches = sum(e.count for e in events if e.key == "cudaGraphLaunch")
    on_device = sum(e.count for e in events if e.device_type == DeviceType.CUDA)
    syncs = sum(e.count for e in events if e.key == "cudaStreamSynchronize")
    device_ms = sum(getattr(e, "self_device_time_total", 0) for e in events) / 1e3
    busy = f"{device_ms / wall_ms:.3f}" if device_ms > 0 else "not measured"
    print(f"profile: {label}: {on_device} kernels, copies and sets run on the card; "
          f"{graph_launches} graph launches and {launches} kernel launches from the host; "
          f"{syncs} stream syncs; device {device_ms:.3f} ms in {wall_ms:.3f} ms of profiled "
          f"wall time (busy {busy})", flush=True)


def replay_line(torch, label, fn, stats, trips, reps=20):
    """The device's share of back-to-back calls of fn (CUDA-event time over
    the host clock of the same calls; a graph's replay keeps the stream
    occupied between its nodes too) and the mean time a node took: the
    event time of one call over the nodes it ran (the graph's top level plus
    each WHILE body times its trips)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    device_ms = start.elapsed_time(end) / reps
    run_nodes = stats.nodes - sum(stats.body_nodes) + sum(
        n * k for n, k in zip(stats.body_nodes, trips))
    print(f"replay: {label}: {device_ms:.3f} ms of the stream a call (CUDA events over {reps} "
          f"back-to-back calls) in {wall_ms:.3f} ms of host wall time (share "
          f"{device_ms / wall_ms:.3f}), {enqueue_ms:.3f} ms of host work to enqueue a call; "
          f"{run_nodes} graph nodes run (bodies of {list(stats.body_nodes)} nodes, trips "
          f"{list(trips)}): {device_ms * 1e3 / run_nodes:.2f} us a node", flush=True)
    return dict(device_ms=device_ms, wall_ms=wall_ms, enqueue_ms=enqueue_ms, nodes_run=run_nodes)


def compare(name, got, ref):
    """Max abs error of got vs ref over tensors, and whether it is within TOL."""
    import torch

    rtol, atol = TOL[name]
    err, ok = 0.0, True
    for g, r in zip(got, ref):
        g, r = g.double(), r.double()
        if not bool(torch.isfinite(g).all()):
            return float("inf"), False
        diff = (g - r).abs()
        err = max(err, float(diff.max()))
        scale = float(r.abs().max())
        ok = ok and bool((diff <= rtol * r.abs() + atol * max(scale, 1.0)).all())
    return err, ok


def against_rbd(name, got, ref):
    """Max abs error of a kernel's output against the spatial-algebra core's,
    and whether it is within RBD_TOL[name] (an absolute atol)."""
    rtol, atol = RBD_TOL[name]
    g, r = got.double(), ref.double()
    diff = (g - r).abs()
    return float(diff.max()), bool(g.isfinite().all() and (diff <= rtol * r.abs() + atol).all())


def rbd_jac_and_qdd(torch, core, x, u):
    """The spatial-algebra core's d qdd / d (x, u) (B, 7, 21) by vmapped
    jacfwd, and its qdd (B, 7)."""
    def one(xi, ui):
        dx, du = torch.func.jacfwd(core.forward_dynamics, argnums=(0, 1))(xi, ui)
        return torch.cat([dx, du], dim=-1)
    return torch.func.vmap(one)(x, u), core.forward_dynamics(x, u)


def bits(t):
    """t's bits (a float tensor viewed as integers: NaN equals NaN)."""
    import torch

    return t.view(torch.int32) if t.dtype == torch.float32 else t


def trace_gap(got, ref, it):
    """|got - ref| / |ref| along two J traces, iterations 0..it (numpy)."""
    import numpy as np

    g, r = (t[:it + 1].double().cpu().numpy() for t in (got, ref))
    return np.abs(g - r) / np.abs(r)


def first_difference(got, ref, it):
    """The first iteration <= it where two alpha traces differ, else None."""
    diff = (got[:it + 1] != ref[:it + 1]).nonzero()
    return int(diff[0, 0]) if len(diff) else None


def at_iters(gap):
    """The gaps at the iterations of GAP_AT that the trace reaches."""
    return "[" + ", ".join(f"{i}: {gap[i]:.1e}" for i in GAP_AT if i < len(gap)) + "]"


def runner_inputs_read(np, args, sim_dt):
    """What the chain's runner mode must read of its inputs (traj_x, traj_u,
    traj_K, t0, traj_dt, t, x, steps): the clocks, the state, and of the plan
    only the knots its clock reaches (x at each knot and the next, u and K at
    each), found by the kernel's own float32 clock and index rule."""
    traj_x, traj_u, traj_K, t0, traj_dt, t, x, steps = args
    n = traj_x.shape[0]
    t_k, t0_h, knots = np.float32(t.item()), np.float32(t0.item()), []
    for _ in range(steps):
        rel = (t_k - t0_h) / np.float32(traj_dt)
        knots.append(int(min(max(np.floor(rel), 0), n - 2)) if np.isfinite(rel) else 0)
        t_k = np.float32(t_k + np.float32(sim_dt))
    lo, hi = min(knots), max(knots)
    return [t0, t, x, traj_x[lo:hi + 2], traj_u[lo:hi + 1], traj_K[lo:hi + 1]]


def kernel_phase(torch, np, dev):
    """Each kernel vs its plain version at the main path's shapes."""
    from parallel_ddp_tpu_torch.config import SolverConfig
    from parallel_ddp_tpu_torch.models.kuka.rbd import KukaRBD
    from parallel_ddp_tpu_torch.ops import cuda_rbd, cuda_riccati, cuda_rollout, cuda_sim_chain

    rng = np.random.default_rng(0)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    results = []
    N, M, A, nx, nu = 64, 4, 16, 14, 7
    dt = 0.5 / (N - 1)

    # -- RBD Jacobian: the derivative stage's N-1 = 63 samples
    x = f32(rng.normal(0, 0.5, (N - 1, nx)))
    u = f32(rng.normal(0, 2.0, (N - 1, nu)))
    got = cuda_rbd.kuka_jac_qdd_cuda(x, u, 1, 0.0)
    ref = cuda_rbd.kuka_jac_qdd_plain(x, u, 1, 0.0)
    err, ok = compare("rbd_jac", got, ref)
    # the Euler AB = E + dt [[0 I 0]; [J]] the solver's derivative stage asks
    # for, against the composer on the plain Jacobian
    ab_call = cuda_rbd.make_kuka_ab(1, 0.0, 1, dt)
    plain_jac = lambda xs, us: torch.cat(
        [torch.cat([torch.zeros(len(xs), nu, nu, device=dev), torch.eye(nu, device=dev).expand(
            len(xs), nu, nu), torch.zeros(len(xs), nu, nu, device=dev)], dim=2),
         cuda_rbd.kuka_jac_qdd_plain(xs, us, 1, 0.0)[0]], dim=1)
    ab_plain = cuda_rbd.make_ab_composer(None, plain_jac, 1, dt, nx, nu)
    ab_err, ab_ok = compare("rbd_jac", [ab_call(x, u)], [ab_plain(x, u)])
    # gravity on (kuka_joint's full-gravity arm): the Jacobian and its Euler AB
    g_err, g_ok = compare("rbd_jac", cuda_rbd.kuka_jac_qdd_cuda(x, u, 1, GRAVITY),
                          cuda_rbd.kuka_jac_qdd_plain(x, u, 1, GRAVITY))
    e, o = compare("rbd_jac", [cuda_rbd.make_kuka_ab(1, GRAVITY, 1, dt)(x, u)],
                   [cuda_rbd.kuka_euler_ab_plain(x.cpu(), u.cpu(), dt, 1, GRAVITY).to(dev)])
    print(f"kernels: rbd_jac at gravity {GRAVITY}: max_abs_err {g_err:.3e}, Euler AB "
          f"{e:.3e} ({'ok' if g_ok and o else 'OUT OF TOLERANCE'})", flush=True)
    err, ok = max(err, g_err, e), ok and g_ok and o
    # the independent spatial-algebra core (KukaRBD) on the card, at both
    # gravities: the kernel's Jacobian and its primal qdd
    core_err, core_ok = 0.0, True
    for grav in (0.0, GRAVITY):
        jac_r, qdd_r = rbd_jac_and_qdd(torch, KukaRBD(1, grav), x, u)
        jac_k, qdd_k = cuda_rbd.kuka_jac_qdd_cuda(x, u, 1, grav)
        (ej, oj), (eq, oq) = against_rbd("rbd_jac", jac_k, jac_r), against_rbd("qdd", qdd_k, qdd_r)
        print(f"kernels: rbd_jac against the spatial-algebra core (KukaRBD), gravity {grav}: "
              f"Jacobian max_abs_err {ej:.3e} (rtol {RBD_TOL['rbd_jac'][0]:g}, atol "
              f"{RBD_TOL['rbd_jac'][1]:g}), qdd {eq:.3e} (rtol {RBD_TOL['qdd'][0]:g}, atol "
              f"{RBD_TOL['qdd'][1]:g}) ({'ok' if oj and oq else 'OUT OF TOLERANCE'}); against "
              f"its plain version {err:.3e}", flush=True)
        core_err, core_ok = max(core_err, ej, eq), core_ok and oj and oq
    ok = ok and core_ok
    host_us, kernel_us = host_and_kernel_us(lambda: cuda_rbd.kuka_jac_qdd_cuda(x, u, 1, 0.0), 1000)
    ab_host_us, ab_kernel_us = host_and_kernel_us(lambda: ab_call(x, u), 1000)
    ab_ms = cuda_ms(lambda: ab_call(x, u), 50)
    print(f"kernels: rbd_jac wrapper: host {host_us:.2f} us per enqueue (1000 enqueues, no "
          f"sync); kernel alone {kernel_us:.2f} us (CUDA-graph replay); Euler AB (63, 14, 21): "
          f"max_abs_err {ab_err:.3e} ({'ok' if ab_ok else 'OUT OF TOLERANCE'}), {ab_ms:.4f} ms "
          f"per call, host {ab_host_us:.2f} us per enqueue, device work alone {ab_kernel_us:.2f} "
          f"us (CUDA-graph replay of every launch of the call)", flush=True)
    results.append(dict(
        name="rbd_jac", route="cuda", source="parallel_ddp_tpu_torch/csrc/rbd_jac.cu",
        replaces="parallel_ddp_tpu/ops/pallas_rbd.py:48", max_abs_err=max(err, ab_err),
        max_abs_err_rbd_core=core_err, ok=ok and ab_ok, host_us=host_us, kernel_us=kernel_us, ms_euler_ab=ab_ms,
        host_us_euler_ab=ab_host_us, kernel_us_euler_ab=ab_kernel_us,
        ms=cuda_ms(lambda: cuda_rbd.kuka_jac_qdd_cuda(x, u, 1, 0.0), 50),
        plain_ms=cuda_ms(lambda: cuda_rbd.kuka_jac_qdd_plain(x, u, 1, 0.0), 5),
        **roofline((x, u), got, count_ops(lambda: cuda_rbd.kuka_jac_qdd_plain(x, u, 1, 0.0)))))

    # -- fused rollout: 16 alphas x 4 blocks, Nf = 16; Euler, plus one RK3 case
    x_sw = f32(rng.normal(0, 0.3, (A, N, nx)))
    uu = f32(rng.normal(0, 1.0, (N, nu)))
    K = f32(rng.normal(0, 0.05, (N, nu, nx)))
    du = f32(rng.normal(0, 0.5, (N, nu)))
    xp = f32(rng.normal(0, 0.3, (N, nx)))
    alphas = f32(SolverConfig(num_alpha=A, alpha_base=0.5).alphas())
    rollout_err, rollout_ok = 0.0, True
    for integ, grav in ((1, 0.0), (3, 0.0), (1, GRAVITY)):
        fused = cuda_rollout.make_kuka_fused_rollout(1, grav, integ, dt, N, M, A)
        got = fused(x_sw, uu, K, du, xp, alphas)
        cpu = [t.cpu() for t in (x_sw, uu, K, du, xp, alphas)]
        ref = fused(*cpu)                     # plain version on CPU tensors
        e, o = compare("rollout", got, [r.to(dev) for r in ref])
        print(f"kernels: rollout integrator {integ}, gravity {grav}: max_abs_err {e:.3e} "
              f"({'ok' if o else 'OUT OF TOLERANCE'})", flush=True)
        rollout_err, rollout_ok = max(rollout_err, e), rollout_ok and o
    skip = torch.zeros((M, N // M), dtype=torch.uint8, device=dev)
    skip[-1, -1] = 1                          # k = N-1
    ro_args = (x_sw, uu, K, du, xp, alphas, skip)
    ro_kw = dict(ee_type=1, gravity=0.0, integrator=1, dt=dt, m_blocks=M)
    host_us, kernel_us = host_and_kernel_us(
        lambda: cuda_rollout.kuka_rollout_cuda(*ro_args, **ro_kw), 1000)
    _, kernel_us_rk3 = host_and_kernel_us(
        lambda: cuda_rollout.kuka_rollout_cuda(*ro_args, **dict(ro_kw, integrator=3)), 10)
    print(f"kernels: rollout wrapper: host {host_us:.2f} us per enqueue (1000 enqueues, no "
          f"sync); kernel alone {kernel_us:.2f} us Euler ({kernel_us / (N // M):.3f} us per "
          f"step), {kernel_us_rk3:.2f} us RK3 (CUDA-graph replay)", flush=True)
    results.append(dict(
        name="rollout", route="cuda", source="parallel_ddp_tpu_torch/csrc/rollout.cu",
        replaces="parallel_ddp_tpu/ops/pallas_rollout.py:76", max_abs_err=rollout_err,
        ok=rollout_ok, host_us=host_us, kernel_us=kernel_us, kernel_us_rk3=kernel_us_rk3,
        ms=cuda_ms(lambda: cuda_rollout.kuka_rollout_cuda(*ro_args, **ro_kw), 50),
        plain_ms=cuda_ms(lambda: cuda_rollout.kuka_rollout_plain(*ro_args, **ro_kw), 3),
        **roofline(ro_args, got, count_ops(
            lambda: cuda_rollout.kuka_rollout_plain(*ro_args, **ro_kw)))))

    # -- fused Riccati on synthetic SPD inputs: 4 lanes x 16 steps at the
    #    Kuka's sizes (the compile-time-size body), 2 lanes x 96 steps at the
    #    same sizes (more steps than the ring's 73 slots: the slots of finished
    #    steps are refilled), 4 lanes x 4 steps at n = 4, m = 2 (the
    #    run-time-size body), and every shape of a plants- or
    #    constraints-phase path (each config those phases solve with), each
    #    against run_block
    synth = lambda n_steps, lanes=M: SolverConfig(num_time_steps=n_steps, m_blocks_b=lanes,
                                                  m_blocks_f=4, num_alpha=A)

    def riccati_case(cfg, n_x, n_u):
        n_steps, M = cfg.num_time_steps, cfg.m_blocks_b
        nb, nm = n_steps // M, n_x + n_u
        C = rng.normal(0, 0.3, (n_steps, nm, nm))
        H = f32(np.einsum("kij,klj->kil", C, C) + np.eye(nm)).reshape(M, nb, nm, nm)
        Cp = rng.normal(0, 0.3, (M, n_x, n_x))
        seeds_P = f32(np.einsum("kij,klj->kil", Cp, Cp) + np.eye(n_x))
        seeds_p = f32(rng.normal(0, 0.5, (M, n_x)))
        AB = np.concatenate([rng.normal(0, 0.3, (n_steps - 1, n_x, nm)), np.zeros((1, n_x, nm))])
        AB = f32(AB).reshape(M, nb, n_x, nm)
        g = f32(rng.normal(0, 0.5, (M, nb, nm)))
        d = f32(rng.normal(0, 0.1, (M, nb, n_x)))
        k_blk = torch.arange(n_steps, device=dev).reshape(M, nb)
        rho = torch.full((), 1.0, device=dev)
        return rho, seeds_P, seeds_p, AB, H, g, d, k_blk

    ric_err, ric_ok, ric_plants = 0.0, True, {}
    cases = [("n=14 m=7, 4 lanes x 16 steps, all staged", synth(N), nx, nu, ()),
             ("n=14 m=7, 2 lanes x 96 steps, ring refilled", synth(192, 2), nx, nu, ()),
             ("n=4 m=2, run-time sizes", synth(16), 4, 2, ())]
    paths = {}                # a plants- or constraints-phase shape -> the paths that run it
    for path, (prob, cfg) in {**plant_problems(np), **constrained_problems(np)}.items():
        n_x, n_u = prob.plant.n_state, prob.plant.n_ctrl
        key = (cfg.num_time_steps, cfg.m_blocks_b, cfg.m_blocks_f, cfg.state_reg, n_x, n_u)
        paths.setdefault(key, (cfg, []))[1].append(path)
    cases += [(f"n={n_x} m={n_u}, {cfg.m_blocks_b} lanes x {cfg.n_blocks_b} steps "
               f"({' / '.join(names)})", cfg, n_x, n_u, names)
              for (*_, n_x, n_u), (cfg, names) in paths.items()]
    for label, cfg, n_x, n_u, names in cases:
        args = riccati_case(cfg, n_x, n_u)
        lanes = cfg.m_blocks_b
        bp = cuda_riccati.make_riccati_block_call(cfg, n_x, n_u)
        got = bp(*args)                       # the kernel, as the solver calls it
        ref = bp(*[a.cpu() for a in args])    # plain version (run_block) on CPU tensors
        if bool(got[7]) or bool(ref[7]):
            fail(f"riccati {label}: synthetic SPD inputs reported a Cholesky failure")
        e, o = compare("riccati", got[:7], [r.to(dev) for r in ref[:7]])
        timing = ""
        if names:
            # a path's shape: its time, apart from the wrapper's host cost,
            # beside its bound, under each path's name (the plants and urdf
            # phases count its launches)
            step = cuda_riccati.make_riccati_step(cfg, n_x, n_u)
            plain = lambda: cuda_riccati.run_block(step, args[0].expand(lanes), *args[1:])
            host_us, kernel_us = host_and_kernel_us(lambda: bp(*args), 200)
            bound = roofline(args, got, count_ops(plain))
            measured = dict(ms=cuda_ms(lambda: bp(*args), 50), plain_ms=cuda_ms(plain, 2),
                            host_us=host_us, kernel_us=kernel_us, bound_ms=bound["bound_ms"],
                            bound_by=bound["bound_by"], max_abs_err=e)
            ric_plants.update({f"{k}_{path}": v for path in names for k, v in measured.items()})
            timing = (f"; {measured['ms']:.4f} ms vs plain "
                      f"{measured['plain_ms']:.3f} ms; host {host_us:.2f} us per "
                      f"enqueue, kernel alone {kernel_us:.2f} us (CUDA-graph replay); bound "
                      f"{bound['bound_ms']:.3e} ms by {bound['bound_by']}")
        print(f"kernels: riccati {label}: max_abs_err {e:.3e} "
              f"({'ok' if o else 'OUT OF TOLERANCE'}){timing}", flush=True)
        ric_err, ric_ok = max(ric_err, e), ric_ok and o
    cfg = synth(N)
    args = riccati_case(cfg, nx, nu)
    bp = cuda_riccati.make_riccati_block_call(cfg, nx, nu)
    got = bp(*args)
    step = cuda_riccati.make_riccati_step(cfg, nx, nu)
    plain = lambda: cuda_riccati.run_block(step, args[0].expand(M), *args[1:])
    host_us, kernel_us = host_and_kernel_us(lambda: bp(*args), 1000)
    print(f"kernels: riccati wrapper: host {host_us:.2f} us per enqueue (1000 enqueues, no "
          f"sync); kernel alone {kernel_us:.2f} us (CUDA-graph replay)", flush=True)
    # what the kernel's time is made of: a fixed part (launch, first slot) and
    # a per-step part (4 block barriers and the one-warp Cholesky per step)
    per_nb = {}
    for nb in (4, 8, 16):
        cfg_nb = SolverConfig(num_time_steps=M * nb, m_blocks_b=M, m_blocks_f=M, num_alpha=A)
        a_nb = riccati_case(cfg_nb, nx, nu)
        bp_nb = cuda_riccati.make_riccati_block_call(cfg_nb, nx, nu)
        per_nb[nb] = host_and_kernel_us(lambda: bp_nb(*a_nb), 10)[1]
    per_step = (per_nb[16] - per_nb[4]) / 12
    print(f"kernels: riccati kernel alone at 4/8/16 steps per lane: "
          f"{per_nb[4]:.2f}/{per_nb[8]:.2f}/{per_nb[16]:.2f} us = "
          f"{per_nb[16] - 16 * per_step:.2f} us fixed + {per_step:.3f} us per step "
          f"(4 block barriers per step)", flush=True)
    results.append(dict(
        name="riccati", route="cuda", source="parallel_ddp_tpu_torch/csrc/riccati.cu",
        replaces="parallel_ddp_tpu/ops/pallas_riccati.py:137", max_abs_err=ric_err, ok=ric_ok,
        ms=cuda_ms(lambda: bp(*args), 50), plain_ms=cuda_ms(plain, 3),
        host_us=host_us, kernel_us=kernel_us, kernel_us_per_step=per_step, **ric_plants,
        **roofline(args, got, count_ops(plain))))

    # -- forward dynamics: one sample (every plant / warm-start step of the
    #    closed loop) and the batched dynamics benchmark's 8192
    qdd = dict(name="qdd", route="cuda", source="parallel_ddp_tpu_torch/csrc/qdd.cu",
               replaces="parallel_ddp_tpu/ops/pallas_rbd.py:39", max_abs_err=0.0,
               max_abs_err_rbd_core=0.0, ok=True)
    for B, grav in [(b, 0.0) for b in QDD_BATCHES] + [(QDD_FD_BATCH, GRAVITY)]:
        x = f32(rng.normal(0, 0.5, (B, nx)))
        u = f32(rng.normal(0, 2.0, (B, nu)))
        got = cuda_rbd.kuka_qdd_cuda(x, u, 1, grav)
        err, ok = compare("qdd", [got], [cuda_rbd.kuka_qdd_plain(x, u, 1, grav)])
        # and against the independent spatial-algebra core on the card
        core_err, core_ok = against_rbd("qdd", got, KukaRBD(1, grav).forward_dynamics(x, u))
        ms = cuda_ms(lambda: cuda_rbd.kuka_qdd_cuda(x, u, 1, grav), 200)
        plain_ms = cuda_ms(lambda: cuda_rbd.kuka_qdd_plain(x, u, 1, grav), 10)
        print(f"kernels: qdd B={B}, gravity {grav}: max_abs_err {err:.3e}, against the "
              f"spatial-algebra core (KukaRBD) {core_err:.3e} (rtol {RBD_TOL['qdd'][0]:g}, atol "
              f"{RBD_TOL['qdd'][1]:g}) ({'ok' if ok and core_ok else 'OUT OF TOLERANCE'}); "
              f"{ms:.4f} ms vs plain {plain_ms:.3f} ms", flush=True)
        qdd["max_abs_err"] = max(qdd["max_abs_err"], err)
        qdd["max_abs_err_rbd_core"] = max(qdd["max_abs_err_rbd_core"], core_err)
        qdd["ok"] = qdd["ok"] and ok and core_ok
        host_us, kernel_us = host_and_kernel_us(lambda: cuda_rbd.kuka_qdd_cuda(x, u, 1, grav), 1000)
        print(f"kernels: qdd B={B} wrapper: host {host_us:.2f} us per enqueue (1000 enqueues, no "
              f"sync); kernel alone {kernel_us:.2f} us (CUDA-graph replay)", flush=True)
        if B == QDD_BATCHES[0]:
            qdd["ms"], qdd["plain_ms"] = ms, plain_ms
            qdd.update(roofline((x, u), [got], count_ops(
                lambda: cuda_rbd.kuka_qdd_plain(x, u, 1, 0.0))))
            qdd["host_us"], qdd["kernel_us"] = host_us, kernel_us
        else:
            qdd[f"ms_b{B}"], qdd[f"plain_ms_b{B}"] = ms, plain_ms
            qdd[f"host_us_b{B}"], qdd[f"kernel_us_b{B}"] = host_us, kernel_us
            qdd[f"bound_ms_b{B}"] = roofline((x, u), [got], count_ops(
                lambda: cuda_rbd.kuka_qdd_plain(x, u, 1, grav)))["bound_ms"]
    results.append(qdd)

    # -- simulation chain, open loop: the MPC warm start's 63 Euler steps from
    #    one state, the cold rollout's 4 blocks x 16 Euler steps, 15 RK3 steps,
    #    the fleet warm start's 256 chains of 63 and the batched cold rollout's
    #    1,024 chains of 16; runner mode: the closed loop's 10 substeps at 1 kHz
    #    under a seeded 64-knot plan (the fig8 phase repeats it from the settled
    #    fig-8 state).  The plain version is the step repeated in a Python loop.
    #    The Euler chain runs a step ahead; it must equal its in-step schedule
    #    bit for bit, and both are timed.
    chain = dict(name="sim_chain", route="cuda",
                 source="parallel_ddp_tpu_torch/csrc/sim_chain.cu",
                 replaces="parallel_ddp_tpu/ops/pallas_rbd.py:39", max_abs_err=0.0, ok=True)
    plan = (f32(rng.normal(0, 0.3, (N, nx))), f32(rng.normal(0, 1.0, (N, nu))),
            f32(rng.normal(0, 0.05, (N, nu, nx))))
    runner_args = (*plan, f32(0.25), dt, f32(0.2617), f32(rng.normal(0, 0.3, nx)), 10)
    for label, integ, lead, T, grav in (
            ("warm start", 1, (), N - 1, 0.0), ("cold rollout", 1, (M,), N // M, 0.0),
            ("rk3", 3, (), 15, 0.0), ("cold rollout gravity", 1, (M,), N // M, GRAVITY),
            ("fleet warm start", 1, (256,), N - 1, 0.0),
            ("batched cold rollout", 1, (1024,), N // M, 0.0), ("runner", 1, None, 10, 0.0)):
        if lead is None:
            sim_dt = 1.0 / FIG8_SIM_HZ
            step = cuda_rollout._kuka_step(1, grav, integ, sim_dt)
            kw = dict(ee_type=1, gravity=grav, integrator=integ, sim_dt=sim_dt)
            call = lambda ahead=True: cuda_sim_chain.kuka_runner_cuda(*runner_args, ahead=ahead,
                                                                      **kw)
            plain = lambda: cuda_sim_chain.runner_plain(step, sim_dt, *runner_args)
            inputs = runner_inputs_read(np, runner_args, sim_dt)
        else:
            x0 = f32(rng.normal(0, 0.3, lead + (nx,)))
            u = f32(rng.normal(0, 1.0, lead + (T, nu)))
            kw = dict(ee_type=1, gravity=grav, integrator=integ, dt=dt)
            step = cuda_rollout._kuka_step(1, grav, integ, dt)
            call = lambda ahead=True: cuda_sim_chain.kuka_open_loop_cuda(x0, u, ahead=ahead, **kw)
            plain = lambda: cuda_sim_chain.open_loop_plain(step, x0, u)
            inputs = (x0, u)
        got = call()
        got = list(got) if lead is None else [got]
        err, ok = compare("sim_chain", got, list(plain()) if lead is None else [plain()])
        ms, plain_ms = cuda_ms(call, 50), cuda_ms(plain, 1, warmup=0)
        host_us, kernel_us = host_and_kernel_us(call, 500)
        bound = roofline(inputs, got, count_ops(plain))
        print(f"kernels: sim_chain {label} (integrator {integ}, gravity {grav}, "
              f"{'runner' if lead is None else lead or (1,)} x T={T}): "
              f"max_abs_err {err:.3e} ({'ok' if ok else 'OUT OF TOLERANCE'}); {ms:.4f} ms vs "
              f"plain {plain_ms:.3f} ms; host {host_us:.2f} us per enqueue (500 enqueues), "
              f"kernel alone {kernel_us:.2f} us ({kernel_us / T:.3f} us per step); bound "
              f"{bound['bound_ms']:.3e} ms by {bound['bound_by']} ({bound['bytes']} B, "
              f"{bound['operations']} operations)", flush=True)
        chain["max_abs_err"] = max(chain["max_abs_err"], err)
        chain["ok"] = chain["ok"] and ok
        key = label.replace(" ", "_")
        if integ == 1:
            # the in-step schedule: the same bits, its own time
            same = all(torch.equal(g, r) for g, r in zip(
                got, call(False) if lead is None else [call(False)]))
            in_step_us = host_and_kernel_us(lambda: call(False), 100)[1]
            print(f"kernels: sim_chain {label}, in-step schedule: "
                  f"{'bit for bit the same' if same else 'DIFFERENT'} states; kernel alone "
                  f"{in_step_us:.2f} us ({in_step_us / T:.3f} us per step) against "
                  f"{kernel_us:.2f} us a step ahead", flush=True)
            chain["ok"] = chain["ok"] and same
            chain[f"kernel_us_in_step_{key}"] = in_step_us
        if label == "warm start":
            chain.update(ms=ms, plain_ms=plain_ms, host_us=host_us, kernel_us=kernel_us, **bound)
        else:
            chain.update({f"ms_{key}": ms, f"plain_ms_{key}": plain_ms,
                          f"host_us_{key}": host_us, f"kernel_us_{key}": kernel_us,
                          f"bound_ms_{key}": bound["bound_ms"],
                          f"bound_by_{key}": bound["bound_by"]})
    results.append(chain)

    for r in results:
        print(f"kernels: {r['name']}: max_abs_err {r['max_abs_err']:.3e} "
              f"(rtol {TOL[r['name']][0]:g}, atol {TOL[r['name']][1]:g} x max|plain|) "
              f"{'ok' if r['ok'] else 'OUT OF TOLERANCE'}; "
              f"{r['ms']:.4f} ms vs plain {r['plain_ms']:.3f} ms; bound {r['bound_ms']:.3e} ms "
              f"by {r['bound_by']} ({r['bytes']} B, {r['operations']} operations); "
              f"library call: none computes this function", flush=True)
    bad = [r["name"] for r in results if not r["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    return results


def counters():
    """Each kernel's launch counters, one per wrapper (the chain kernel has
    one wrapper per mode): eager launches count on the host, launches inside
    a CUDA graph on the device, once per replay that ran them."""
    from parallel_ddp_tpu_torch.ops import cuda_rbd, cuda_riccati, cuda_rollout, cuda_sim_chain

    return {"rbd_jac": (cuda_rbd.kuka_jac_qdd_cuda.counter,),
            "rollout": (cuda_rollout.kuka_rollout_cuda.counter,),
            "riccati": (cuda_riccati.riccati_cuda.counter,), "qdd": (cuda_rbd.kuka_qdd_cuda.counter,),
            "sim_chain": (cuda_sim_chain.kuka_open_loop_cuda.counter,
                          cuda_sim_chain.kuka_runner_cuda.counter)}


def reset_counts():
    for wrappers in counters().values():
        for c in wrappers:
            c.reset()


def read_counts():
    return {name: sum(c.launches for c in wrappers) for name, wrappers in counters().items()}


def require_launched(path, counts):
    """Fail if a kernel of `path` was launched no time in that path's run."""
    idle = [k for k in PATH_KERNELS[path] if counts[k] <= 0]
    if idle:
        fail(f"{path}: kernels of this path never launched: {idle} ({counts})")


def solve_phase(torch, np, dev):
    """The WAFR solve, cold + warm, each one graph replay, with the launch
    counters; the cold and the first warm solve again on CPU tensors."""
    from parallel_ddp_tpu_torch.presets import ee_goal, figure8_goal, kuka_ee
    from parallel_ddp_tpu_torch.solver import make_ilqr_solver

    prob = kuka_ee()
    cfg = dataclasses.replace(prob.cfg, max_iter=N_ITERS, tol_cost=0.0, pallas_riccati=True)
    solver = make_ilqr_solver(prob.plant, prob.cost, cfg)
    N = cfg.num_time_steps
    # the canonical cold start of the convergence goldens (one seeded state
    # at every knot, zero torques) toward the latency benchmark's goal; the
    # benchmark's own per-knot random x0/u0 leaves every line-search
    # candidate worse than J0, so no step would be accepted
    x_start = (np.random.default_rng(0).standard_normal(14) * 0.3).astype(np.float32)
    x0 = np.broadcast_to(x_start, (N, 14)).copy()
    u0 = np.zeros((N, 7), np.float32)
    goal0 = [0.0, -0.55, 0.35]
    goals = [goal0] + [list(figure8_goal(MPC_DT * i)[0]) for i in range(1, N_WARM + 1)]
    goals_dev = [ee_goal(g, device=dev) for g in goals]
    x0_dev, u0_dev = torch.as_tensor(x0, device=dev), torch.as_tensor(u0, device=dev)

    def warm(prev, goal):
        return solver(prev.x, prev.u, goal, P0=prev.P, p0=prev.p, d0=prev.d, initial_rollout=False)

    # the first calls capture the two graphs (a cold start rolls out, a warm
    # one is given P0, p0 and d0): neither capture is in the counted run
    warm(solver(x0_dev, u0_dev, goals_dev[0], initial_rollout=True), goals_dev[1])
    torch.cuda.synchronize()

    reset_counts()
    outs = [solver(x0_dev, u0_dev, goals_dev[0], initial_rollout=True)]
    for i in range(1, N_WARM + 1):
        outs.append(warm(outs[-1], goals_dev[i]))
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"solve: kernel launches during the cold + {N_WARM} warm solves (graph replays, "
          f"counted on the device): {json.dumps(launches)}", flush=True)
    # the solve's kernels: its cold rollout is one chain launch, so the
    # single-evaluation qdd kernel is not on this path
    require_launched("wafr_solve", launches)

    for i, out in enumerate(outs):
        it = int(out.iters)
        jt = out.J_trace.cpu().numpy()[: it + 1]
        at = out.alpha_trace.cpu().numpy()[1: it + 1]
        kind = "cold" if i == 0 else f"warm{i}"
        print(f"solve: {kind}: J {np.array2string(jt, precision=4)} alphas {at.tolist()} "
              f"max_defect {float(out.max_defect):.3e}", flush=True)
        if not np.all(np.isfinite(jt)):
            fail(f"{kind} solve: non-finite J")
        if np.any(np.diff(jt) > 0):
            fail(f"{kind} solve: J increased")
    if not outs[0].J_trace[int(outs[0].iters)] < outs[0].J_trace[0]:
        fail("cold solve did not reduce J below J0")

    # the cold and the first warm solve on CPU tensors: the plain versions of
    # every kernel, the host loops
    cpu_solver = make_ilqr_solver(prob.plant, prob.cost, cfg)
    cold = outs[0]
    cpu_outs = [
        cpu_solver(torch.as_tensor(x0), torch.as_tensor(u0), ee_goal(goals[0], device="cpu"),
                   initial_rollout=True),
        cpu_solver(cold.x.cpu(), cold.u.cpu(), ee_goal(goals[1], device="cpu"), P0=cold.P.cpu(),
                   p0=cold.p.cpu(), d0=cold.d.cpu(), initial_rollout=False)]
    for kind, gpu, cpu in (("cold", outs[0], cpu_outs[0]), ("warm1", outs[1], cpu_outs[1])):
        gj = gpu.J_trace.cpu().numpy()[: int(gpu.iters) + 1]
        cj = cpu.J_trace.numpy()[: int(cpu.iters) + 1]
        ga = gpu.alpha_trace.cpu().numpy()[: int(gpu.iters) + 1]
        ca = cpu.alpha_trace.numpy()[: int(cpu.iters) + 1]
        print(f"solve: cpu (plain) {kind}: J {np.array2string(cj, precision=4)} "
              f"alphas {ca[1:].tolist()}", flush=True)
        if ga.shape != ca.shape or not np.array_equal(ga, ca) or not np.allclose(
                gj, cj, rtol=SOLVE_RTOL, atol=0.0):
            fail(f"GPU and CPU {kind} solves disagree (alphas {ga.tolist()} vs {ca.tolist()}, "
                 f"rtol {SOLVE_RTOL})")
    print(f"solve: GPU (graph replay) and CPU (host loop) cold and warm traces agree (same "
          f"alphas, J within rtol {SOLVE_RTOL}); host reads of a GPU solve {solver.host_syncs}, "
          f"of the CPU's warm solve {cpu_solver.host_syncs}", flush=True)
    canon = dict(x0=x0_dev, u0=u0_dev, goals=goals_dev[:2])
    return solver, outs[0], goals_dev[1], launches, canon


def timing_phase(torch, np, dev, solver, cold, goal):
    """The first warm re-solve (from the cold solve's output toward the next
    figure-8 goal), replayed: one MPC step's solve."""

    def one():
        return solver(cold.x, cold.u, goal, P0=cold.P, p0=cold.p, d0=cold.d)

    for _ in range(3):
        one()
    # the syncs torch itself reports for one warm solve, beside the count
    # the solver keeps: both must be 0
    _, torch_syncs = count_syncs(torch, one)
    torch.cuda.synchronize()
    reset_counts()
    one()
    torch.cuda.synchronize()
    per_solve = read_counts()
    print(f"timing: kernel launches in one replayed warm solve: {json.dumps(per_solve)}",
          flush=True)
    times = event_times(one, N_TIMED)
    print(f"timing: warm {N_ITERS}-iteration solve (one graph replay): median "
          f"{float(np.median(times)):.3f} ms, min {min(times):.3f}, max {max(times):.3f} over "
          f"{N_TIMED} solves; host reads {solver.host_syncs} (torch sync-debug count "
          f"{torch_syncs})", flush=True)
    if solver.host_syncs or torch_syncs:
        fail(f"a replayed warm solve synchronised with the host ({solver.host_syncs} reads, "
             f"torch sync-debug count {torch_syncs})")
    return float(np.median(times)), one, per_solve


def fig8_goals(torch, np, times, x_init, dev):
    """The figure-8 goal at each time, as the (T,)-leading goal dict the
    device loop takes (benchmarks/fig8.py goals_for)."""
    from parallel_ddp_tpu_torch.presets import figure8_goal

    xyz = np.stack([figure8_goal(t, FIG8_TRACK_S)[0] for t in times])
    g = np.concatenate([xyz, np.zeros_like(xyz)], axis=1).astype(np.float32)
    return {"ee_goal": torch.as_tensor(g, device=dev),
            "x_target": torch.as_tensor(np.tile(x_init, (len(times), 1)), device=dev)}


def plant_cases(np):
    """The four problems of the plants phase at their presets' full sizes:
    (preset, start state (n,), start controls (m,), goal, iteration cap),
    from the JAX package's own uses (tests/test_solver.py:26-110,
    examples/wafr_ilqr.py:44-48 and its default --max-iter)."""
    hover = -9.81 * 0.5 / 4.0          # per-rotor thrust balancing gravity
    kuka_sig = np.concatenate([np.full(7, 1.0), np.full(7, 0.5)])
    return {
        "pendulum": ("pendulum_swingup", np.zeros(2), np.zeros(1), [np.pi, 0.0], 100),
        "cartpole": ("cartpole_swingup", np.zeros(4), np.zeros(1), [0.0, np.pi, 0.0, 0.0], 150),
        "quadrotor": ("quadrotor_task", np.zeros(12), np.full(4, -hover),
                      [1.0, 1.0, 0.5] + [0.0] * 9, 100),
        "kuka_joint": ("kuka_joint", kuka_sig * np.random.default_rng(0).normal(0, 1.0, 14),
                       np.zeros(7), [-0.5, 1.0, -0.3, 0.5, 0.7, 0.7, 0.0] + [0.0] * 7, 40),
    }


def plant_problems(np):
    """Every problem the plants and urdf phases solve, with its solver config
    (the fused Riccati sweep on), by path: the four presets at full size
    (their warm re-solves and kuka_joint's FD solve run the same shapes), the
    quadrotor at the JAX test's N = 64 over 2 s (tests/test_solver.py:86-101),
    the pendulum's MPC loop, N = 32 over 1 s (tests/test_mpc.py:116-135), and
    the URDF iiwa-14 at the WAFR shape.  The kernel phase holds the Riccati
    kernel at each of their shapes."""
    from parallel_ddp_tpu_torch import presets

    out = {}
    for name, (preset, *_, max_iter) in plant_cases(np).items():
        prob = getattr(presets, preset)()
        out[name] = (prob, dataclasses.replace(prob.cfg, pallas_riccati=True, max_iter=max_iter))
    prob = presets.quadrotor_task(num_time_steps=64, total_time=2.0)
    out["quadrotor_n64"] = (prob, dataclasses.replace(prob.cfg, pallas_riccati=True,
                                                      max_iter=out["quadrotor"][1].max_iter))
    prob = presets.pendulum_swingup(num_time_steps=32, total_time=1.0, m_blocks=2, num_alpha=8)
    out["pendulum_loop"] = (prob, dataclasses.replace(prob.cfg, pallas_riccati=True))
    out["urdf_iiwa14"] = urdf_wafr_problem()
    return out


def urdf_wafr_problem():
    """The urdf phase's problem: the packaged iiwa-14 URDF at the WAFR shape
    with the EE cost (URDF_GOAL's problem), the fused Riccati sweep on."""
    from parallel_ddp_tpu_torch import presets
    from parallel_ddp_tpu_torch.models.urdf import IIWA14_URDF

    prob = presets.urdf_problem(IIWA14_URDF, ee=True, gravity=0.0, num_time_steps=64,
                                total_time=0.5, m_blocks=4, num_alpha=16, integrator=1)
    return prob, dataclasses.replace(prob.cfg, pallas_riccati=True)


def convergence(np, name, out, goal, test_size=True):
    """The JAX package's own convergence checks of this problem
    (tests/test_solver.py), at its bars: (what they read, what failed).
    The quadrotor's test runs N = 64 over 2 s; at another size (test_size
    False) its J ratio bar does not apply: the hover thrust's control cost
    alone, 0.5 * 5 * 4 * 1.226^2 a knot, is 1,909 of the preset's J0 = 3,036
    at N = 128 (0.63 of it), against 947 of 2,072 at the test's N = 64."""
    it = int(out.iters)
    jt = out.J_trace.cpu().numpy()[: it + 1].astype(np.float64)
    at = out.alpha_trace.cpu().numpy()[: it + 1]
    js = [j for j, a in zip(jt, at) if a >= 0]
    xf = out.x[-1].cpu().numpy().astype(np.float64)
    md = float(out.max_defect)
    bad = []
    if not np.all(np.isfinite(jt)):
        bad.append("non-finite J")
    if not all(b <= a + 1e-3 for a, b in zip(js, js[1:])):
        bad.append("accepted J increased")
    ratio = js[-1] / js[0]
    read = (f"accepted J {js[0]:.4f} -> {js[-1]:.4f} (last / first {ratio:.4f}; {len(js) - 1} of "
            f"{it} steps accepted), max_defect {md:.3e}")
    if name == "pendulum":
        bad += [b for b, c in (("last / first >= 0.15", ratio >= 0.15),
                               ("|q_f - pi| >= 0.2", abs(xf[0] - np.pi) >= 0.2),
                               ("max_defect >= 0.05", md >= 0.05)) if c]
        read += f", |q_f - pi| {abs(xf[0] - np.pi):.4f}"
    elif name == "cartpole":
        bad += [b for b, c in (("last / first >= 0.55", ratio >= 0.55),
                               ("max_defect >= 0.75", md >= 0.75)) if c]
    elif name == "quadrotor":
        dist = float(np.linalg.norm(xf[:3] - np.asarray(goal[:3])))
        bad += [b for b, c in (("last / first >= 0.5", test_size and ratio >= 0.5),
                               ("last / first >= 1", ratio >= 1.0),
                               ("|xyz_f - goal| >= 0.4", dist >= 0.4)) if c]
        read += f", |xyz_f - goal| {dist:.4f}"
    elif not ratio < 1.0:
        bad.append("J not reduced")
    return read, bad


def first_tie(np, out, tie):
    """The first iteration at which the solve's decision is a near tie at the
    rounding level `tie`: a rejected step, or an accepted one that gained less
    than `tie` of J.  Two float32 runs of the solve (the card's kernels, the
    CPU's plain versions) may part there, not before."""
    it = int(out.iters)
    jt = out.J_trace.cpu().numpy()[: it + 1].astype(np.float64)
    at = out.alpha_trace.cpu().numpy()[: it + 1]
    for i in range(1, it + 1):
        if at[i] < 0 or (jt[i - 1] - jt[i]) / jt[i - 1] < tie:
            return i
    return it + 1


def traces_read(gpu, cpu, capped):
    """The two solves' iterations and alphas, as printed."""
    it_g, it_c = int(gpu.iters), int(cpu.iters)
    return (f"card iters {it_g}, CPU iters {it_c}{' (capped)' if capped else ''}; alphas card "
            f"{gpu.alpha_trace[1:it_g + 1].tolist()} CPU {cpu.alpha_trace[1:it_c + 1].tolist()}")


def hold_to_cpu(np, label, gpu, cpu, cap=None):
    """The card's solve against the CPU's (the CPU's capped at `cap`
    iterations if given: where it stops there, its trace is a prefix of the
    same solve's): alphas equal up to the CPU trace's first near tie
    (PLANT_TIE), J within SOLVE_RTOL up to the parting, the final J within
    SOLVE_RTOL, or PLANT_FINAL_RTOL after a parting.  Returns the printed
    reading."""
    it_g, it_c = int(gpu.iters), int(cpu.iters)
    capped = cap is not None and it_c >= cap
    k = min(it_g, it_c)
    part = first_difference(gpu.alpha_trace.cpu(), cpu.alpha_trace, k)
    if part is None and it_g != it_c and not capped:
        part = k + 1
    allowed = first_tie(np, cpu, PLANT_TIE)
    upto = k + 1 if part is None else part
    gap = trace_gap(gpu.J_trace, cpu.J_trace, k)
    end_g = float(gpu.J_trace[it_c]) if capped else float(gpu.J)
    final = abs(end_g - float(cpu.J)) / abs(float(cpu.J))
    read = (f"{traces_read(gpu, cpu, capped)}; first difference at {part} (first near tie of "
            f"the CPU trace at {allowed}); J gap by iteration {at_iters(gap)}, max before the "
            f"parting {gap[:upto].max():.2e}; final J gap {final:.2e}")
    if part is not None and part < allowed:
        fail(f"plants {label}: the card's alphas part from the CPU's at iteration {part}, "
             f"before the first near tie ({allowed}): {read}")
    if gap[:upto].max() > SOLVE_RTOL:
        fail(f"plants {label}: J on the card and the CPU differ by {gap[:upto].max():.2e} > "
             f"{SOLVE_RTOL} before the paths part: {read}")
    bar = SOLVE_RTOL if part is None else PLANT_FINAL_RTOL
    if final > bar:
        fail(f"plants {label}: final J differs by {final:.2e} > {bar}: {read}")
    return read


def hold_fd_to_cpu(np, gpu, cpu, moved, cap):
    """kuka_joint's FD solve on the card against the CPU's.  The CPU's FD
    solves from the start moved by ULP_MOVES ulps (`moved`) part from the
    CPU's by `env`, the running largest relative J gap (each held at its
    last J past its end).  Held: J within FD_ENVELOPE_FACTOR x env (never
    tighter than J_TRACE_FLOOR) at every iteration both solves ran and at
    their ends, and the card's first step one that the CPU's solve or a
    moved one takes.  Returns the printed reading."""
    it_g, it_c = int(gpu.iters), int(cpu.iters)
    capped = cap is not None and it_c >= cap
    k = min(it_g, it_c)
    cj = cpu.J_trace[: it_c + 1].double().numpy()
    held = lambda o: np.concatenate([o.J_trace[: min(int(o.iters), it_c) + 1].double().numpy(),
                                     np.full(max(0, it_c - int(o.iters)), float(o.J))])
    env = np.maximum.accumulate(np.max([np.abs(held(o) - cj) / np.abs(cj) for o in moved], 0))
    env = np.maximum(env, J_TRACE_FLOOR)
    gap = trace_gap(gpu.J_trace, cpu.J_trace, k)
    end_g = float(gpu.J_trace[it_c]) if capped else float(gpu.J)
    final = abs(end_g - float(cpu.J)) / abs(float(cpu.J))
    env_end = max([env[-1]] + [abs(float(o.J) - float(cpu.J)) / abs(float(cpu.J)) for o in moved])
    ratio = max(float((gap / env[: k + 1]).max()), final / env_end)
    firsts = {int(cpu.alpha_trace[1])} | {int(o.alpha_trace[1]) for o in moved}
    read = (f"{traces_read(gpu, cpu, capped)}; moved starts' alphas "
            f"{[o.alpha_trace[1:int(o.iters) + 1].tolist() for o in moved]}; J gap by iteration "
            f"{at_iters(gap)}, final {final:.2e}; the moved starts' envelope {at_iters(env)}, "
            f"final {env_end:.2e}; gap / envelope at most {ratio:.3f} (limit "
            f"{FD_ENVELOPE_FACTOR:g})")
    if ratio > FD_ENVELOPE_FACTOR or int(gpu.alpha_trace[1]) not in firsts:
        fail(f"plants kuka_joint FD: the FD solves on the card and the CPU disagree beyond the "
             f"rounding envelope: {read}")
    return read


def hold_fd_ab(np, prob, cfg, xs, us, dev):
    """kuka_joint's FD AB at the cold trajectory (one qdd launch), held as
    tests/test_torch_plants.py holds the FD Jacobian: the card's steps at the
    very points the FD steps (z +- eps e_i) against the CPU's within the qdd
    kernel's tolerance; the card's FD AB against the CPU's within their steps'
    largest gap over eps plus 2 ulps of the column (the difference and the
    division); the CPU's against the Jacobian kernel's AB within
    FD_ROUNDING_ULPS ulps of max|x'| over eps plus that kernel's tolerance,
    and the card's within the sum of the two bounds."""
    import torch

    from parallel_ddp_tpu_torch.ops.integrators import make_step, make_step_jacobian_fd

    fd = make_step_jacobian_fd(prob.plant, cfg.integrator, cfg.dt, cfg.fd_eps)
    reset_counts()
    ab_fd = fd(xs, us)
    launches = read_counts()["qdd"]
    ab_cpu = fd(xs.cpu(), us.cpu()).to(dev)
    ab_k = prob.plant.batched_step_jac(cfg.integrator, cfg.dt)(xs, us)
    n_s = prob.plant.n_state
    z = torch.cat([xs, us], -1)
    delta = torch.eye(z.shape[-1], device=dev) * cfg.fd_eps
    pts = torch.cat([z + delta[:, None], z - delta[:, None]]).reshape(-1, z.shape[-1])
    step = make_step(prob.plant, cfg.integrator, cfg.dt)
    x_card = step(pts[:, :n_s], pts[:, n_s:])
    x_cpu = step(pts[:, :n_s].cpu(), pts[:, n_s:].cpu()).to(dev)
    step_err, step_ok = compare("qdd", [x_card], [x_cpu])
    ulp = 2.0 ** -24
    tol_pair = step_err / cfg.fd_eps + 2 * ulp * float(ab_cpu.abs().max())
    rtol, atol = TOL["rbd_jac"]
    tol_ab = (FD_ROUNDING_ULPS * ulp * float(x_cpu.abs().max()) / cfg.fd_eps
              + rtol * ab_k.abs() + atol * float(ab_k.abs().max()))
    pair_err = float((ab_fd - ab_cpu).abs().max())
    cpu_ok = bool(((ab_cpu - ab_k).abs() <= tol_ab).all())
    card_ok = bool(((ab_fd - ab_k).abs() <= tol_ab + tol_pair).all())
    print(f"plants: kuka_joint FD AB at the cold trajectory ({xs.shape[0]} samples, {launches} "
          f"qdd launch of {pts.shape[0]} samples): the steps at its points, card vs CPU "
          f"{step_err:.3e} ({'ok' if step_ok else 'OUT OF TOLERANCE'}); FD AB card vs CPU "
          f"{pair_err:.3e} (bound {tol_pair:.3e}); max |FD - rbd_jac| CPU "
          f"{float((ab_cpu - ab_k).abs().max()):.3e}, card {float((ab_fd - ab_k).abs().max()):.3e}"
          f" (bound {FD_ROUNDING_ULPS} ulp(max|x'|) / eps = "
          f"{FD_ROUNDING_ULPS * ulp * float(x_cpu.abs().max()) / cfg.fd_eps:.3e} + the Jacobian "
          f"kernel's tolerance, + {tol_pair:.3e} for the card's)", flush=True)
    if launches != 1 or not (step_ok and pair_err <= tol_pair and cpu_ok and card_ok):
        fail(f"plants kuka_joint: FD AB out of its bounds or {launches} qdd launches")


def on(torch, a, dev):
    """a (an array, or a dict of them: an EE goal) as tensors on dev."""
    if isinstance(a, dict):
        return {k: on(torch, v, dev) for k, v in a.items()}
    return torch.as_tensor(a, device=dev)


def replay(torch, path, solver, args, by_path, **kw):
    """One solve on the card (the capture first), replayed with the launch
    counters zeroed just before and read just after into by_path[path]; 0
    host reads."""
    solver(*args, **kw)
    torch.cuda.synchronize()
    reset_counts()
    out, syncs = count_syncs(torch, lambda: solver(*args, **kw))
    torch.cuda.synchronize()
    by_path[path] = read_counts()
    require_launched(path, by_path[path])
    if solver.host_syncs or syncs:
        fail(f"{path}: the replayed solve read the host ({solver.host_syncs} reads, torch "
             f"sync-debug count {syncs})")
    return out


def solve_pair(torch, dev, phase, path, prob, cfg, x0, u0, goal, by_path, cpu_iters=None):
    """One cold solve replayed on the card and the same solve on CPU tensors
    (capped at cpu_iters iterations if given); the card's solver is returned
    too (its graphs)."""
    from parallel_ddp_tpu_torch.solver import make_ilqr_solver

    args = [on(torch, a, dev) for a in (x0, u0, goal)]
    t0 = time.perf_counter()
    solver = make_ilqr_solver(prob.plant, prob.cost, cfg)
    gpu = replay(torch, path, solver, args, by_path, initial_rollout=True)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = make_ilqr_solver(prob.plant, prob.cost, cfg)(
        *(on(torch, a, "cpu") for a in (x0, u0, goal)), initial_rollout=True,
        iter_limit=cpu_iters)
    print(f"{phase}: {path}: cold solve captured and replayed in {card_s:.1f} s with 0 host "
          f"reads; launches {json.dumps(by_path[path])}; CPU solve "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return gpu, cpu, solver


def plants_phase(torch, np, dev, card):
    """The WAFR example's pendulum, cart-pole, quadrotor and joint-space Kuka
    at their presets' full sizes with the fused Riccati sweep: each cold
    solve one graph replay (launches counted, 0 host reads) held against the
    same solve on CPU tensors and to the JAX package's convergence bars; a
    warm 6-iteration re-solve timed; kuka_joint with finite differences; the
    pendulum's device loop."""
    from parallel_ddp_tpu_torch.mpc.device_loop import make_device_mpc_loop
    from parallel_ddp_tpu_torch.mpc.driver import MPCConfig, MPCController, MPCState
    from parallel_ddp_tpu_torch.solver import make_ilqr_solver

    t_phase = time.perf_counter()
    by_path, summary = {}, {}
    problems = plant_problems(np)

    for name, (_, x_start, u_start, goal, _) in plant_cases(np).items():
        prob, cfg = problems[name]
        N = cfg.num_time_steps
        x0 = np.tile(np.asarray(x_start, np.float32), (N, 1))
        u0 = np.tile(np.asarray(u_start, np.float32), (N, 1))
        goal = np.asarray(goal, np.float32)
        cap = PLANT_CPU_ITERS.get(name)
        gpu, cpu, _ = solve_pair(torch, dev, "plants", f"plants_{name}", prob, cfg, x0, u0, goal,
                                 by_path, cap)
        print(f"plants: {name}: {hold_to_cpu(np, name, gpu, cpu, cap)}", flush=True)
        for side, out in (("card", gpu),) + ((("CPU", cpu),) if cap is None else ()):
            read, bad = convergence(np, name, out, goal, name != "quadrotor")
            print(f"plants: {name}: {side}: {read}", flush=True)
            if bad:
                fail(f"plants {name}: the {side} solve misses the JAX package's bars: {bad}")
        if name == "quadrotor":
            prob_t, cfg_t = problems["quadrotor_n64"]
            test_args = [torch.as_tensor(a, device=dev) for a in (x0[:64], u0[:64], goal)]
            out_t = replay(torch, "plants_quadrotor_n64",
                           make_ilqr_solver(prob_t.plant, prob_t.cost, cfg_t), test_args, by_path,
                           initial_rollout=True)
            read, bad = convergence(np, name, out_t, goal)
            print(f"plants: quadrotor at the JAX test's N = 64 over 2 s: card: {read}; launches "
                  f"{json.dumps(by_path['plants_quadrotor_n64'])}", flush=True)
            if bad:
                fail(f"plants quadrotor (N = 64): misses the JAX package's bars: {bad}")

        # the warm re-solve from the cold solve's end: the same work on every
        # plant (tol_cost = 0, exactly N_ITERS iterations)
        warm = make_ilqr_solver(prob.plant, prob.cost,
                                dataclasses.replace(cfg, tol_cost=0.0, max_iter=N_ITERS))
        g_dev = torch.as_tensor(goal, device=dev)
        one = lambda: warm(gpu.x, gpu.u, g_dev, P0=gpu.P, p0=gpu.p, d0=gpu.d)
        one()
        reset_counts()
        w_out = one()
        torch.cuda.synchronize()
        per_solve = read_counts()
        times = event_times(one, N_TIMED)
        stats = warm.graphs.stats()[-1]
        w_alphas = w_out.alpha_trace[1:].tolist()
        summary[name] = dict(warm_ms=float(np.median(times)), body_nodes=stats.body_nodes,
                             nodes=stats.nodes, launches=per_solve, alphas=w_alphas)
        print(f"plants: {name}: warm {N_ITERS}-iteration re-solve (one graph replay): median "
              f"{float(np.median(times)):.3f} ms, min {min(times):.3f}, max {max(times):.3f} over "
              f"{N_TIMED}; alphas {w_alphas} ({sum(a >= 0 for a in w_alphas)} of {N_ITERS} "
              f"accepted); graph {stats.nodes} nodes, WHILE bodies {list(stats.body_nodes)} (the "
              f"first is the iteration's); launches a re-solve {json.dumps(per_solve)}; on {card}",
              flush=True)

        if name == "kuka_joint":
            # finite differences: the FD AB at the cold trajectory, then the
            # FD solve card vs CPU, beside the CPU's from moved starts
            hold_fd_ab(np, prob, cfg, gpu.x[:-1].contiguous(), gpu.u[:-1].contiguous(), dev)
            fd_cfg = dataclasses.replace(cfg, use_finite_diff=True)
            fd_gpu, fd_cpu, _ = solve_pair(torch, dev, "plants", "plants_kuka_joint_fd", prob,
                                           fd_cfg, x0, u0, goal, by_path, cap)
            cpu_fd = make_ilqr_solver(prob.plant, prob.cost, fd_cfg)
            moved = []
            for k in ULP_MOVES:
                xm = x0
                for _ in range(abs(k)):
                    xm = np.nextafter(xm, np.float32(np.inf if k > 0 else -np.inf))
                moved.append(cpu_fd(torch.as_tensor(xm), torch.as_tensor(u0),
                                    torch.as_tensor(goal), initial_rollout=True, iter_limit=cap))
            print(f"plants: kuka_joint FD: {hold_fd_to_cpu(np, fd_gpu, fd_cpu, moved, cap)}",
                  flush=True)

    # the pendulum's closed loop (tests/test_mpc.py:116-135): 3 iterations a
    # solve, 200 Hz RK3 plant, 0.05 s a control step
    prob, cfg = problems["pendulum_loop"]
    ctrl = MPCController(prob.plant, prob.cost, cfg, MPCConfig(max_iters_per_solve=3))
    run = make_device_mpc_loop(ctrl, sim_rate_hz=200.0, control_period_s=0.05, sim_integrator=3)
    goal = torch.tensor([np.pi, 0.0], device=dev)
    x0 = torch.tensor([np.pi - 0.4, 0.3], device=dev)
    st = ctrl.init_state(x0, t0=0.0, goal=goal)
    goals = goal[None].expand(PEND_LOOP_STEPS, 2).contiguous()
    run(st, x0, 0.0, goals)                        # the capture
    torch.cuda.synchronize()
    reset_counts()
    res, syncs = count_syncs(torch, lambda: run(st, x0, 0.0, goals))
    torch.cuda.synchronize()
    by_path["plants_pendulum_loop"] = loop_counts = read_counts()
    require_launched("plants_pendulum_loop", loop_counts)
    xf = res.x[-1].cpu().numpy()
    ok_rate = float(res.ok[5:].float().mean())
    print(f"plants: pendulum device loop ({PEND_LOOP_STEPS} control steps, one graph replay "
          f"each): final state {xf.tolist()}, ok rate after step 5 {ok_rate:.3f}, host reads "
          f"{res.host_syncs} (torch sync-debug count {syncs}); launches {json.dumps(loop_counts)}",
          flush=True)
    if abs(xf[0] - np.pi) >= 0.1 or abs(xf[1]) >= 0.5 or ok_rate <= 0.8:
        fail("plants: the pendulum device loop misses tests/test_mpc.py's bars")
    if res.host_syncs or syncs:
        fail(f"plants: pendulum loop: {res.host_syncs} host reads, {syncs} syncs")
    st_cpu = MPCState(*(a.cpu() for a in st))
    cpu = run(st_cpu, x0.cpu(), 0.0, goals[:PEND_CPU_STEPS].cpu())
    acc_ok = torch.equal(res.accepted[:PEND_CPU_STEPS].cpu(), cpu.accepted)
    j_gap = float(((res.J[:PEND_CPU_STEPS].cpu() - cpu.J).abs() / cpu.J.abs()).max())
    x_gap = float((res.x[:PEND_CPU_STEPS].cpu() - cpu.x).abs().max())
    print(f"plants: pendulum device loop, {PEND_CPU_STEPS} steps on CPU tensors: same accepts "
          f"{acc_ok}, J gap {j_gap:.2e} (rtol {SOLVE_RTOL}), state gap {x_gap:.2e} (atol "
          f"{PEND_X_ATOL})", flush=True)
    if not acc_ok or j_gap > SOLVE_RTOL or x_gap > PEND_X_ATOL:
        fail("plants: the pendulum device loop on the card and the CPU disagree")
    print(f"plants: phase took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return by_path, summary


def urdf_phase(torch, np, dev, card, kuka_warm_ms):
    """The URDF front end and the spatial-algebra core on the card: the
    packaged iiwa-14 parsed and held to the Kuka constants; the core's
    dynamics and AB on the card against CPU tensors; the WAFR-shape URDF
    solve cold (one replay, launches counted, 0 host reads) against the CPU's
    by the plants phase's rule, then the warm 6-iteration re-solve timed
    beside the kernel-backed Kuka's (kuka_warm_ms)."""
    from parallel_ddp_tpu_torch.models.kuka import params as kp
    from parallel_ddp_tpu_torch.models.urdf import IIWA14_URDF, load_urdf
    from parallel_ddp_tpu_torch.ops.integrators import make_step_jacobian
    from parallel_ddp_tpu_torch.presets import ee_goal
    from parallel_ddp_tpu_torch.solver import make_ilqr_solver

    t_phase = time.perf_counter()
    # 1. the parser against the hardcoded constants, at tests/test_urdf.py's
    #    bounds (:129-158): link 7's baked inertia is rounded by 2e-5 there
    arm = load_urdf(IIWA14_URDF)
    r_t, p_t, i_sp, _, _ = kp.build_constants(ee_type=0)
    diffs = dict(r_tree=np.abs(arm.r_tree - r_t).max(), p_tree=np.abs(arm.p_tree - p_t).max(),
                 i_spatial_1_6=np.abs(arm.i_spatial[:6] - i_sp[:6]).max(),
                 i_spatial_7=np.abs(arm.i_spatial[6] - i_sp[6]).max())
    bars = dict(r_tree=1e-7, p_tree=0.0, i_spatial_1_6=0.0, i_spatial_7=3e-5)
    limits_ok = (abs(arm.pos_upper[1] - 2.09439510239) <= 1e-9 * 2.09439510239
                 and float(arm.effort_limit[0]) == 300.0)
    print(f"urdf: parsed {IIWA14_URDF.split(os.sep)[-1]}: {arm.n} joints "
          f"{''.join(arm.joint_types)}; max |URDF - build_constants(ee_type=0)| "
          + ", ".join(f"{k} {v:.3e} (bar {bars[k]:g})" for k, v in diffs.items())
          + f"; limits {'ok' if limits_ok else 'WRONG'}", flush=True)
    if any(diffs[k] > bars[k] for k in bars) or arm.n != 7 or not limits_ok:
        fail("urdf: the parsed iiwa-14 differs from the Kuka constants")

    # 2. the core on the card against the same core on CPU tensors, at the
    #    derivative stage's samples: qdd, and the Euler step's AB by vmapped
    #    jacfwd (what the solve's derivative stage runs)
    prob, cfg = urdf_wafr_problem()
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(0, 0.5, (URDF_SAMPLES, 14)).astype(np.float32), device=dev)
    u = torch.as_tensor(rng.normal(0, 2.0, (URDF_SAMPLES, 7)).astype(np.float32), device=dev)
    core_ok = True
    for grav in (0.0, GRAVITY):
        core = arm.rbd(gravity=grav)
        qdd = core.forward_dynamics(x, u)
        e_q, o_q = compare("qdd", [qdd], [core.forward_dynamics(x.cpu(), u.cpu()).to(dev)])
        ab_fn = torch.func.vmap(make_step_jacobian(
            dataclasses.replace(prob.plant, dynamics=core.forward_dynamics), 1, cfg.dt))
        ab = ab_fn(x, u)
        e_ab, o_ab = compare("rbd_jac", [ab], [ab_fn(x.cpu(), u.cpu()).to(dev)])
        ms_q, ms_ab = cuda_ms(lambda: core.forward_dynamics(x, u), 20), cuda_ms(
            lambda: ab_fn(x, u), 10)
        print(f"urdf: spatial-algebra core, gravity {grav}, {URDF_SAMPLES} samples, card vs CPU "
              f"tensors: qdd max_abs_err {e_q:.3e}, Euler AB {e_ab:.3e} (the qdd and rbd_jac "
              f"tolerances: {'ok' if o_q and o_ab else 'OUT OF TOLERANCE'}); eager on the card "
              f"{ms_q:.3f} ms a qdd call, {ms_ab:.3f} ms an AB call ({ab.dtype}) on {card}",
              flush=True)
        core_ok = core_ok and o_q and o_ab and ab.dtype == torch.float32
    if not core_ok:
        fail("urdf: the spatial-algebra core on the card disagrees with the CPU")

    # 3. the solve: cold from the goldens' seeded start, one replay, against
    #    the same solve on CPU tensors by the plants phase's rule
    by_path = {}
    N = cfg.num_time_steps
    x_start = (np.random.default_rng(0).standard_normal(14) * 0.3).astype(np.float32)
    x0 = np.broadcast_to(x_start, (N, 14)).copy()
    u0 = np.zeros((N, 7), np.float32)
    goal = {k: v.numpy() for k, v in ee_goal(URDF_GOAL, device="cpu").items()}
    gpu, cpu, solver = solve_pair(torch, dev, "urdf", "urdf_iiwa14", prob, cfg, x0, u0, goal,
                                  by_path)
    cold = solver.graphs.stats()[-1]
    print(f"urdf: urdf_iiwa14: {hold_to_cpu(np, 'urdf_iiwa14', gpu, cpu)}", flush=True)
    ee_err = lambda out: float(np.linalg.norm(
        prob.plant.ee_pos(out.x[-1, :7]).cpu().numpy()[:3] - np.asarray(URDF_GOAL)))
    start_err = float(np.linalg.norm(prob.plant.ee_pos(torch.as_tensor(x_start[:7])).numpy()[:3]
                                     - np.asarray(URDF_GOAL)))
    it = int(gpu.iters)
    jt = gpu.J_trace.cpu().numpy()[: it + 1]
    print(f"urdf: cold solve on the card: J {jt[0]:.4f} -> {float(gpu.J):.4f} in {it} iterations, "
          f"max_defect {float(gpu.max_defect):.3e}, EE error to the goal {ee_err(gpu):.4f} m "
          f"(start {start_err:.4f} m; CPU {ee_err(cpu):.4f} m); graph captured and instantiated "
          f"in {cold.seconds:.2f} s, {cold.nodes} nodes, WHILE bodies {list(cold.body_nodes)}",
          flush=True)
    if not (np.all(np.isfinite(jt)) and float(gpu.J) < jt[0]
            and float(gpu.max_defect) < URDF_MAX_DEFECT and ee_err(gpu) < start_err):
        fail("urdf: the cold solve did not converge (J, defects or EE error)")

    # 4. the warm re-solve from the cold solve's end (tol_cost = 0: exactly
    #    N_ITERS iterations), timed
    warm = make_ilqr_solver(prob.plant, prob.cost,
                            dataclasses.replace(cfg, tol_cost=0.0, max_iter=N_ITERS))
    g_dev = on(torch, goal, dev)
    one = lambda: warm(gpu.x, gpu.u, g_dev, P0=gpu.P, p0=gpu.p, d0=gpu.d)
    one()
    torch.cuda.synchronize()
    reset_counts()
    _, syncs = count_syncs(torch, one)
    torch.cuda.synchronize()
    per_solve = read_counts()
    times = event_times(one, N_TIMED)
    stats = warm.graphs.stats()[-1]
    warm_ms = float(np.median(times))
    print(f"urdf: warm {N_ITERS}-iteration re-solve (one graph replay): median {warm_ms:.3f} ms, "
          f"min {min(times):.3f}, max {max(times):.3f} over {N_TIMED}; {warm_ms / kuka_warm_ms:.1f}"
          f" x the kernel-backed Kuka's {kuka_warm_ms:.3f} ms (timing phase); graph captured "
          f"and instantiated in {stats.seconds:.2f} s, {stats.nodes} nodes, WHILE bodies "
          f"{list(stats.body_nodes)} (the first is the iteration's); host reads "
          f"{warm.host_syncs} (torch sync-debug count {syncs}); riccati launches "
          f"{per_solve['riccati']} a re-solve, {by_path['urdf_iiwa14']['riccati']} in the cold "
          f"solve; on {card}", flush=True)
    if warm.host_syncs or syncs or per_solve["riccati"] < N_ITERS:
        fail(f"urdf: the warm re-solve read the host or skipped the Riccati kernel "
             f"({warm.host_syncs} reads, {syncs} syncs, {per_solve})")
    print(f"urdf: phase took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return by_path, dict(warm_ms=warm_ms, body_nodes=stats.body_nodes, nodes=stats.nodes,
                         capture_s=stats.seconds, cold_nodes=cold.nodes,
                         cold_capture_s=cold.seconds, launches=per_solve)


def constrained_problems(np):
    """Every problem the constraints phase solves, with its solver config (the
    fused Riccati sweep on), by path: the WAFR Kuka EE problem for the
    torque-limited solve and the constrained batched solve (6 iterations,
    tol_cost 0), and tests/test_constraints.py:63-107's pendulum, N = 48
    over 2 s, 2 + 2 blocks, 8 alphas, RK3.  The kernel phase holds the
    Riccati kernel at each of their shapes."""
    from parallel_ddp_tpu_torch import presets

    kuka = presets.kuka_ee()
    cfg = dataclasses.replace(kuka.cfg, max_iter=AL_MAX_ITER, pallas_riccati=True)
    pend = presets.pendulum_swingup(num_time_steps=48, total_time=2.0, m_blocks=2, num_alpha=8)
    return {"constrained_wafr": (kuka, cfg),
            "constrained_batched": (kuka, dataclasses.replace(cfg, max_iter=N_ITERS,
                                                              tol_cost=0.0)),
            "constrained_pendulum_loop": (pend, dataclasses.replace(pend.cfg,
                                                                   pallas_riccati=True))}


def constraints_phase(torch, np, dev, card):
    """Box constraints at the WAFR width: the torque-limited Kuka EE solve
    (`make_al_solver`: the outer loop on the host, each inner solve one
    replay), a constrained batched solve with a lam per scenario, and the
    pendulum's constrained MPC closed loop (`ALMPCController`, one replay a
    period); each path's launches counted with the counters zeroed just
    before it."""
    from torch.utils import _pytree as pytree

    from parallel_ddp_tpu_torch.constraints import (ALConfig, ALMPCController, BoxConstraints,
                                                    al_cost, make_al_solver)
    from parallel_ddp_tpu_torch.mpc.driver import MPCConfig, MPCState
    from parallel_ddp_tpu_torch.ops.integrators import make_step
    from parallel_ddp_tpu_torch.parallel.sharding import make_batched_solver
    from parallel_ddp_tpu_torch.presets import ee_goal
    from parallel_ddp_tpu_torch.solver import make_ilqr_solver

    t_phase = time.perf_counter()
    problems = constrained_problems(np)
    by_path, summary = {}, {}
    on_cpu = lambda tree: pytree.tree_map(lambda t: t.cpu(), tree)

    # -- the torque-limited WAFR Kuka EE solve: the first call captures the
    #    inner solver's two graphs (cold, warm), the second is counted
    prob, cfg = problems["constrained_wafr"]
    N, n, m = cfg.num_time_steps, prob.plant.n_state, prob.plant.n_ctrl
    con = BoxConstraints(n_state=n, n_ctrl=m, u_min=[-AL_U_MAX] * m, u_max=[AL_U_MAX] * m)
    al_cfg = ALConfig(max_outer=AL_MAX_OUTER)
    al = make_al_solver(prob.plant, prob.cost, cfg, con, al_cfg)
    goal = ee_goal(AL_GOAL, device=dev)
    x0, u0 = torch.zeros(N, n, device=dev), torch.zeros(N, m, device=dev)
    t0 = time.perf_counter()
    al(x0, u0, goal)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    (out, info), syncs = count_syncs(torch, lambda: al(x0, u0, goal))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    by_path["constrained_wafr"] = read_counts()
    require_launched("constrained_wafr", by_path["constrained_wafr"])
    u_peak = float(out.u.abs().max())
    ee_err = float(torch.linalg.norm(prob.plant.ee_pos(out.x[-1][:7])[:3]
                                     - torch.tensor(AL_GOAL, device=dev)))
    viols = info["violations"]
    reads = info["outer_iters"] + 1
    print(f"constraints: torque-limited WAFR solve (|u| <= {AL_U_MAX:g} Nm, N = {N}, at most "
          f"{AL_MAX_OUTER} outer x {AL_MAX_ITER} inner iterations): {info['outer_iters']} outer "
          f"iterations, violations {[float(f'{v:.4e}') for v in viols]}, final mu "
          f"{info['mu']:g}, base_J {info['base_J']:.4f} (AL J {float(out.J):.4f}), max|u| "
          f"{u_peak:.5f}, EE error {ee_err:.4f} m (start {AL_START_ERR}); {wall_s:.3f} s of host "
          f"wall time (the captures before it {capture_s:.1f} s); host reads {syncs} (torch "
          f"sync-debug count: one a violation and one for base_J, {reads} expected), inner "
          f"solves' own {al.solver.host_syncs}; launches {json.dumps(by_path['constrained_wafr'])}",
          flush=True)
    if syncs != reads or al.solver.host_syncs:
        fail(f"constraints: the torque-limited solve read the host {syncs} times (want {reads}) "
             f"and its inner solves {al.solver.host_syncs}")
    # the same solve from the goal moved by -AL_ULPS..AL_ULPS ulps: the
    # readings' spread, held to the JAX package's (AL_JAX_Q3)
    readings = {}
    for k in range(-AL_ULPS, AL_ULPS + 1):
        g = np.asarray(AL_GOAL, np.float32)
        for _ in range(abs(k)):
            g = np.nextafter(g, np.float32(np.inf if k > 0 else -np.inf))
        o, inf = (out, info) if k == 0 else al(x0, u0, ee_goal(g.tolist(), device=dev))
        err = float(torch.linalg.norm(prob.plant.ee_pos(o.x[-1][:7])[:3]
                                      - torch.tensor(AL_GOAL, device=dev)))
        readings[k] = (inf["violations"][-1], float(o.u.abs().max()), err)
    v, u_max, errs = (np.asarray([r[i] for r in readings.values()]) for i in range(3))
    quart = lambda a: "[" + ", ".join(f"{q:.4g}" for q in np.quantile(a, [0, .25, .5, .75, 1])) + "]"
    test_bars = {f"max|u| <= {AL_U_BAR:g}": u_peak <= AL_U_BAR,
                 f"last violation < {AL_VIOL_BAR:g}": viols[-1] < AL_VIOL_BAR,
                 f"EE error < {AL_START_ERR - AL_EE_GAIN:g}": ee_err < AL_START_ERR - AL_EE_GAIN}
    summary["al_spread"] = dict(last_violation=sorted(v.tolist()), max_abs_u=sorted(u_max.tolist()),
                                ee_err=sorted(errs.tolist()))
    print(f"constraints: the JAX test's bars (set at N = 16) on this solve: {test_bars}; the same "
          f"solve from the goal moved by -{AL_ULPS}..{AL_ULPS} ulps ({len(v)} solves): last "
          f"violation quartiles (min, q1, median, q3, max) {quart(v)} (the JAX package's q3 "
          f"{AL_JAX_Q3['last_violation']}), max|u| {quart(u_max)} (q3 "
          f"{AL_JAX_Q3['max_abs_u']}), EE error {quart(errs)}; by k "
          + ", ".join(f"{k}: {r[0]:.3e}" for k, r in readings.items()), flush=True)
    bad = [b for b, c in (
        (f"median last violation > {AL_JAX_Q3['last_violation']}",
         np.median(v) > AL_JAX_Q3["last_violation"]),
        (f"median max|u| > {AL_JAX_Q3['max_abs_u']}", np.median(u_max) > AL_JAX_Q3["max_abs_u"]),
        (f"an EE error >= {AL_START_ERR - AL_EE_GAIN:g}",
         errs.max() >= AL_START_ERR - AL_EE_GAIN)) if c]
    if bad:
        fail(f"constraints: the torque-limited WAFR solve reads worse than the JAX package's: {bad}")

    # its first outer solve (lam 0, mu_init) replayed, then on CPU tensors
    # capped at AL_CPU_ITERS iterations: the same alphas, J within SOLVE_RTOL
    lam0 = torch.zeros(N, con.n_c, device=dev)
    first_goal = {"base": goal, "lam": lam0, "mu": torch.full((), al_cfg.mu_init, device=dev)}
    first = al.solver(x0, u0, first_goal, initial_rollout=True)
    cpu_solver = make_ilqr_solver(prob.plant, al_cost(prob.cost, con, N - 1), cfg)
    t0 = time.perf_counter()
    cpu = cpu_solver(x0.cpu(), u0.cpu(), on_cpu(first_goal), initial_rollout=True,
                     iter_limit=AL_CPU_ITERS)
    cpu_s = time.perf_counter() - t0
    k = int(cpu.iters)
    part = first_difference(first.alpha_trace.cpu(), cpu.alpha_trace, k)
    gap = trace_gap(first.J_trace, cpu.J_trace, k)
    print(f"constraints: first outer solve, card against CPU tensors ({cpu_s:.1f} s, capped at "
          f"{AL_CPU_ITERS}): {traces_read(first, cpu, k >= AL_CPU_ITERS)}; J gap by iteration "
          f"{at_iters(gap)}", flush=True)
    if part is not None or (k < AL_CPU_ITERS and int(first.iters) != k) or gap.max() > SOLVE_RTOL:
        fail(f"constraints: the first outer solve on the card and the CPU disagree (first "
             f"difference at {part}, J gap up to {gap.max():.2e}, rtol {SOLVE_RTOL})")

    # ms per inner-solve replay: the first outer solve (cold, from zeros) and
    # the last one's warm re-solve with the final multipliers
    mu_last = torch.full((), info["mu"], device=dev)
    last_goal = {"base": goal, "lam": info["lam"], "mu": mu_last}
    warm = lambda: al.solver(out.x, out.u, last_goal, P0=out.P, p0=out.p, d0=out.d)
    w_out = warm()
    cold = lambda: al.solver(x0, u0, first_goal, initial_rollout=True)
    ms = {name: float(np.median(event_times(fn, N_TIMED))) for name, fn in
          (("cold", cold), ("warm", warm))}
    summary["inner_ms"] = ms
    print(f"constraints: inner-solve replays (median of {N_TIMED}, CUDA events): cold first "
          f"outer solve {ms['cold']:.3f} ms for {int(first.iters)} iterations, warm re-solve with "
          f"the final multipliers {ms['warm']:.3f} ms for {int(w_out.iters)} iterations; graphs "
          f"{len(al.solver.graphs)} (cold, warm) for every outer iteration and call; on {card}",
          flush=True)

    # -- the constrained batched WAFR solve: one replay of 6 iterations, a
    #    different lam each scenario, three scenarios against their single
    #    solves by the batched phase's rule
    prob_b, cfg_b = problems["constrained_batched"]
    cost_b = al_cost(prob_b.cost, con, N - 1)
    B = AL_BATCH
    tile = lambda t: t[None].expand((B,) + t.shape).contiguous()
    scale = torch.linspace(0.0, 1.0, B, device=dev)
    goals = {"base": pytree.tree_map(tile, goal), "lam": scale[:, None, None] * info["lam"],
             "mu": torch.full((B,), info["mu"], device=dev)}
    x0s, u0s = tile(x0), tile(u0)
    solve = make_batched_solver(prob_b.plant, cost_b, cfg_b)
    solve(x0s, u0s, goals)                                         # the capture
    torch.cuda.synchronize()
    reset_counts()
    out_b, syncs_b = count_syncs(torch, lambda: solve(x0s, u0s, goals))
    torch.cuda.synchronize()
    by_path["constrained_batched"] = read_counts()
    require_launched("constrained_batched", by_path["constrained_batched"])
    J = out_b.J.cpu().numpy()
    batch_ms = float(np.median(event_times(lambda: solve(x0s, u0s, goals), BATCH_TIMED)))
    summary["batched_ms"] = batch_ms
    print(f"constraints: batched WAFR solve at B={B} ({cfg_b.max_iter} iterations, tol_cost "
          f"{cfg_b.tol_cost:g}, lam scaled 0 to 1 over the scenarios): {batch_ms:.3f} ms a replay "
          f"(median of {BATCH_TIMED}), {B / batch_ms * 1e3:.0f} solves/s; J {J.min():.4f} to "
          f"{J.max():.4f} ({len(set(J.tolist()))} distinct); host reads "
          f"{solve.solver.host_syncs} (torch sync-debug count {syncs_b}); launches "
          f"{json.dumps(by_path['constrained_batched'])}", flush=True)
    if solve.solver.host_syncs or syncs_b or not np.all(np.isfinite(J)) or len(set(J.tolist())) < 2:
        fail("constraints: the batched solve read the host, gave a non-finite J, or its "
             "scenarios' multipliers took no effect")
    single = make_ilqr_solver(prob_b.plant, cost_b, cfg_b)
    for b in AL_BATCH_SAMPLES:
        hold_scenario(torch, np, "constraints: batched", solve, single, out_b, x0s, u0s, goals, b)
    del out_b

    # -- the pendulum's constrained MPC closed loop: one replay a period, two
    #    RK3 plant steps of the clipped command; peaks kept on the device
    prob_p, cfg_p = problems["constrained_pendulum_loop"]
    con_p = BoxConstraints(n_state=2, n_ctrl=1, u_min=[-AL_PEND_U_MAX], u_max=[AL_PEND_U_MAX])
    ctrl = ALMPCController(prob_p.plant, prob_p.cost, cfg_p,
                           MPCConfig(max_iters_per_solve=N_ITERS), con_p, mu=AL_PEND_MU)
    sim = make_step(prob_p.plant, 3, AL_PEND_SIM_DT)

    def closed_loop(st, lam, x, goal_p, periods, record):
        t = 0.0
        zero = torch.zeros((), device=x.device)
        head, tail, executed, rec = zero, zero, zero, []
        for i in range(periods):
            st, lam, step_info = ctrl.step(st, lam, x, t, goal_p)
            head = torch.maximum(head, st.u[0].abs().max())
            tail = torch.maximum(tail, st.u.abs().max())
            for _ in range(AL_PEND_SUBSTEPS):
                u = con_p.clip_u(st.u[0])
                executed = torch.maximum(executed, u.abs().max())
                x = sim(x, u)
                t += AL_PEND_SIM_DT
            if i < record:
                rec.append((step_info.J, step_info.accepted, x))
        return st, lam, x, t, head, tail, executed, rec

    goal_p = torch.tensor([np.pi, 0.0], device=dev)
    x_start = torch.zeros(2, device=dev)
    st0, lam0 = ctrl.init_state(x_start, t0=0.0, goal=goal_p)
    ctrl.step(st0, lam0, x_start, 0.0, goal_p)                     # the capture
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res, syncs_p = count_syncs(torch, lambda: closed_loop(st0, lam0, x_start, goal_p,
                                                          AL_PEND_PERIODS, PEND_CPU_STEPS))
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    by_path["constrained_pendulum_loop"] = read_counts()
    require_launched("constrained_pendulum_loop", by_path["constrained_pendulum_loop"])
    st_f, lam_f, x_f, t_f, head, tail, executed, rec = res
    xf = x_f.cpu().numpy()
    read = dict(q_err=abs(float(xf[0]) - np.pi), qd=abs(float(xf[1])), head=float(head),
                tail=float(tail), plan=float(st_f.u.abs().max()))
    period_ms = float(np.median(event_times(lambda: ctrl.step(st_f, lam_f, x_f, t_f, goal_p),
                                            N_TIMED)))
    summary["period_ms"] = period_ms
    stats = ctrl.graphs.stats()[0]
    print(f"constraints: pendulum constrained MPC ({AL_PEND_PERIODS} periods, one replay each, "
          f"|u| <= {AL_PEND_U_MAX:g}, mu {AL_PEND_MU:g}): final state {xf.tolist()}; |q - pi| "
          f"{read['q_err']:.4f}, |qd| {read['qd']:.4f}, head peak {read['head']:.4f}, tail peak "
          f"{read['tail']:.4f}, final plan {read['plan']:.4f}, executed peak {float(executed):.4f} "
          f"(bars {AL_PEND_BARS}); {loop_s:.2f} s for the loop; a period {period_ms:.3f} ms "
          f"(median of {N_TIMED} replays, CUDA events), graph {stats.nodes} nodes (WHILE bodies "
          f"{list(stats.body_nodes)}); host reads {ctrl.host_syncs} (torch sync-debug count "
          f"{syncs_p} over the whole loop); launches "
          f"{json.dumps(by_path['constrained_pendulum_loop'])}; on {card}", flush=True)
    missed = [k for k, bar in AL_PEND_BARS.items() if not read[k] <= bar]
    if missed or float(executed) > AL_PEND_U_MAX:
        fail(f"constraints: the pendulum constrained MPC misses tests/test_constraints.py's bars: "
             f"{missed}, executed peak {float(executed)}")
    if ctrl.host_syncs or syncs_p:
        fail(f"constraints: pendulum loop: {ctrl.host_syncs} host reads, {syncs_p} syncs")
    # the first PEND_CPU_STEPS periods on CPU tensors
    cpu_rec = closed_loop(MPCState(*(a.cpu() for a in st0)), lam0.cpu(), x_start.cpu(),
                          goal_p.cpu(), PEND_CPU_STEPS, PEND_CPU_STEPS)[-1]
    acc_ok = all(bool(g[1]) == bool(c[1]) for g, c in zip(rec, cpu_rec))
    j_gap = max(abs(float(g[0]) - float(c[0])) / abs(float(c[0])) for g, c in zip(rec, cpu_rec))
    x_gap = max(float((g[2].cpu() - c[2]).abs().max()) for g, c in zip(rec, cpu_rec))
    print(f"constraints: pendulum constrained MPC, {PEND_CPU_STEPS} periods on CPU tensors: same "
          f"accepts {acc_ok}, J gap {j_gap:.2e} (rtol {SOLVE_RTOL}), state gap {x_gap:.2e} (atol "
          f"{PEND_X_ATOL})", flush=True)
    if not acc_ok or j_gap > SOLVE_RTOL or x_gap > PEND_X_ATOL:
        fail("constraints: the pendulum constrained MPC on the card and the CPU disagree")
    print(f"constraints: phase took {time.perf_counter() - t_phase:.1f} s", flush=True)
    caches = {"AL inner solver": al.solver.graphs, "AL batched solver": solve.solver.graphs,
              "AL MPC period": ctrl.graphs}
    return by_path, summary, caches


def fig8_phase(torch, np, dev, card):
    """The figure-8 closed loop (benchmarks/fig8.py, device-loop mode) through
    the port on dev, with the launch counters; then FIG8_CPU_STEPS control
    steps from the settled state on the GPU and on the CPU."""
    from parallel_ddp_tpu_torch.mpc.device_loop import make_device_mpc_loop
    from parallel_ddp_tpu_torch.mpc.driver import MPCConfig, MPCController, MPCState
    from parallel_ddp_tpu_torch.ops import cuda_rollout, cuda_sim_chain
    from parallel_ddp_tpu_torch.ops.integrators import make_step
    from parallel_ddp_tpu_torch.parallel.backward import backward_pass
    from parallel_ddp_tpu_torch.parallel.forward import forward_pass, line_search
    from parallel_ddp_tpu_torch.presets import fig8_weights, kuka_ee
    from parallel_ddp_tpu_torch.solver import _derivatives

    prob = kuka_ee(mpc_mode=True)
    cfg = dataclasses.replace(prob.cfg, pallas_riccati=True)
    ctrl = MPCController(prob.plant, prob.cost, cfg, MPCConfig(max_iters_per_solve=N_ITERS))
    run = make_device_mpc_loop(ctrl, sim_rate_hz=FIG8_SIM_HZ, control_period_s=FIG8_PERIOD,
                               sim_integrator=1)
    w = fig8_weights()
    x_init = np.zeros(14, np.float32)
    x_init[1], x_init[3], x_init[5] = np.pi / 4, -np.pi / 4, np.pi / 4
    n_settle = int(round(FIG8_SETTLE_S / FIG8_PERIOD))
    n_track = int(round(FIG8_TRACK_S / FIG8_PERIOD))
    goals_settle = fig8_goals(torch, np, np.zeros(n_settle), x_init, dev)
    goals_track = fig8_goals(torch, np, (np.arange(n_track) + 1) * FIG8_PERIOD, x_init, dev)
    fields = ("x", "ee_err", "J", "accepted", "ok")

    def run_steps(st, x, t, goals, n):
        """n control steps in chunks; host clock around each synced chunk."""
        outs, wall, syncs = [], 0.0, 0
        for i in range(0, n, FIG8_CHUNK):
            seg = {k: v[i:min(i + FIG8_CHUNK, n)] for k, v in goals.items()}
            m = seg["ee_goal"].shape[0]
            t0 = time.perf_counter()
            res = run(st, x, t, seg, w)
            torch.cuda.synchronize(dev)
            wall += time.perf_counter() - t0
            st, x, t = res.state, res.x[m - 1], t + m * FIG8_PERIOD
            outs.append(res)
            syncs += res.host_syncs
        series = {f: torch.cat([getattr(r, f) for r in outs]) for f in fields}
        return st, x, t, series, wall, syncs

    # the first calls capture the cold solve's and the control step's graphs:
    # neither capture is in the counted run
    x_init_dev = torch.as_tensor(x_init, device=dev)
    goal_start = {k: v[0] for k, v in goals_settle.items()}
    run(ctrl.init_state(x_init_dev, t0=0.0, goal=goal_start, weights=w), x_init_dev, 0.0,
        {k: v[:1] for k, v in goals_settle.items()}, w)
    torch.cuda.synchronize()

    reset_counts()
    t_phase = time.perf_counter()
    st = ctrl.init_state(x_init_dev, t0=0.0, goal=goal_start, weights=w)
    st, x, t, settle, settle_wall, _ = run_steps(st, x_init, 0.0, goals_settle, n_settle)
    settled = (MPCState(*(a.clone() for a in st)), x.clone(), t)
    ms_settle = settle_wall * 1e3 / n_settle
    # shorten the track (never the settle, never the width) if it would not
    # fit the phase's budget at the settle's pace
    left_s = FIG8_BUDGET_S - (time.perf_counter() - t_phase)
    n_run = n_track
    if ms_settle * n_track / 1e3 > left_s:
        n_run = max(FIG8_CHUNK, int(left_s * 1e3 / ms_settle) // FIG8_CHUNK * FIG8_CHUNK)
        print(f"fig8: CUT: the track is shortened to {n_run} of {n_track} control steps "
              f"({n_run * FIG8_PERIOD:g} s of {FIG8_TRACK_S:g} s) at {ms_settle:.1f} ms per step",
              flush=True)
    before_track = read_counts()
    st, x, t, track, track_wall, track_syncs = run_steps(
        st, x, t, {k: v[:n_run] for k, v in goals_track.items()}, n_run)
    fig8_counts = read_counts()           # this path's own: init + settle + track
    per_step = {k: (fig8_counts[k] - before_track[k]) / n_run for k in fig8_counts}
    qdd_family = per_step["qdd"] + per_step["sim_chain"]

    if track_syncs:
        fail(f"fig8: {track_syncs} host reads on the track (a control step must make none)")
    errs = track["ee_err"].cpu().numpy()
    settle_errs = settle["ee_err"].cpu().numpy()
    ok_rate = float(track["ok"].float().mean())
    ms_step = track_wall * 1e3 / n_run
    print(f"fig8: settle {n_settle} steps, final EE error {settle_errs[-1]:.4f} m, "
          f"{ms_settle:.3f} ms per control step", flush=True)
    print(f"fig8: track {n_run} steps: {ms_step:.3f} ms per control step (host clock around "
          f"synced {FIG8_CHUNK}-step chunks) on {card}", flush=True)
    print(f"fig8: average EE error {float(np.mean(errs)):.4f} m, max {float(np.max(errs)):.4f} m "
          f"(bar {FIG8_BAR_M} m); ok rate {ok_rate:.3f}; accept rate "
          f"{float(track['accepted'].float().mean()):.3f}; host syncs per control step "
          f"{track_syncs / n_run:.2f}", flush=True)
    print(f"fig8: kernel launches during init + settle + track: {json.dumps(fig8_counts)}; per "
          f"control step on the track: {json.dumps(per_step)}; forward-dynamics family (qdd + "
          f"sim_chain): {qdd_family:.2f}", flush=True)
    if not (np.all(np.isfinite(errs)) and np.all(np.isfinite(settle_errs))):
        fail("fig8: non-finite EE error")
    if float(np.mean(errs)) > FIG8_BAR_M:
        fail(f"fig8: average EE error {float(np.mean(errs)):.4f} m above {FIG8_BAR_M} m")
    require_launched("fig8", fig8_counts)
    if qdd_family > FIG8_QDD_FAMILY_MAX:
        fail(f"fig8: {qdd_family:.2f} forward-dynamics-family launches per control step "
             f"(at most {FIG8_QDD_FAMILY_MAX})")

    # from the settled state: control steps on the GPU and the CPU, then
    # the stages of one control step; the warm-start
    # rollout and the substeps also the way they ran before the chain kernel
    # (a Python loop with one forward-dynamics launch per step)
    st0, x0, t0 = settled
    goal0 = {k: v[0] for k, v in goals_track.items()}
    ks = torch.arange(cfg.num_time_steps, device=dev)
    s0 = torch.zeros((), dtype=torch.int32, device=dev)
    t0_dev = torch.full((), t0, dtype=torch.float32, device=dev)   # no copy from the host

    def gpu_vs_cpu(label, loop):
        """FIG8_CPU_STEPS control steps from the settled state on the GPU and
        on CPU tensors (the plain versions): they must agree."""
        seg = {k: v[:FIG8_CPU_STEPS] for k, v in goals_track.items()}
        loop(st0, x0, t0_dev, {k: v[:1] for k, v in seg.items()}, w)   # first-use work
        gpu, torch_syncs = count_syncs(torch, lambda: loop(st0, x0, t0_dev, seg, w))
        cpu = loop(MPCState(*(a.cpu() for a in st0)), x0.cpu(), t0,
                   {k: v.cpu() for k, v in seg.items()}, w)
        g_err, c_err = gpu.ee_err.cpu().numpy(), cpu.ee_err.numpy()
        g_j, c_j = gpu.J.cpu().numpy(), cpu.J.numpy()
        g_acc, c_acc = gpu.accepted.cpu().numpy(), cpu.accepted.numpy()
        print(f"fig8: {label}: {FIG8_CPU_STEPS} steps from the settled state: GPU EE error "
              f"{g_err.tolist()} J {g_j.tolist()} accepted {g_acc.tolist()}; CPU EE error "
              f"{c_err.tolist()} J {c_j.tolist()} accepted {c_acc.tolist()}; host syncs "
              f"{gpu.host_syncs} (torch sync-debug count {torch_syncs})", flush=True)
        if not (np.array_equal(g_acc, c_acc) and np.allclose(g_j, c_j, rtol=SOLVE_RTOL, atol=0.0)
                and np.allclose(g_err, c_err, rtol=0.0, atol=FIG8_ERR_ATOL)):
            fail(f"fig8: {label}: GPU and CPU control steps disagree (J rtol {SOLVE_RTOL}, "
                 f"EE error atol {FIG8_ERR_ATOL} m)")
        if torch_syncs or gpu.host_syncs:
            fail(f"fig8: {label}: the GPU's control steps synchronised with the host "
                 f"({gpu.host_syncs} reads, torch sync-debug count {torch_syncs})")
        print(f"fig8: {label}: GPU and CPU agree (same accepts, J within rtol {SOLVE_RTOL}, EE "
              f"error within {FIG8_ERR_ATOL} m)", flush=True)

    gpu_vs_cpu("full re-rollout", run)
    # ten replayed control steps under torch's sync debug mode
    seg10 = {k: v[:10] for k, v in goals_track.items()}
    _, loop_syncs = count_syncs(torch, lambda: run(st0, x0, t0_dev, seg10, w))
    print(f"fig8: 10 replayed control steps: torch sync-debug count {loop_syncs}", flush=True)
    if loop_syncs:
        fail(f"fig8: 10 replayed control steps made {loop_syncs} stream syncs")
    # a path of its own: the block re-rollout warm start (full_rollout=False),
    # the first block by the chain, the two boundary defects by single steps
    # of the qdd kernel; 1 + FIG8_CPU_STEPS control steps on the card
    ctrl_blk = MPCController(prob.plant, prob.cost, cfg,
                             MPCConfig(max_iters_per_solve=N_ITERS, full_rollout=False))
    run_blk = make_device_mpc_loop(ctrl_blk, sim_rate_hz=FIG8_SIM_HZ,
                                   control_period_s=FIG8_PERIOD, sim_integrator=1)
    run_blk(st0, x0, t0_dev, {k: v[:1] for k, v in goals_track.items()}, w)   # the capture
    torch.cuda.synchronize()
    reset_counts()
    gpu_vs_cpu("block re-rollout", run_blk)
    blk_counts = read_counts()
    n_blk = 1 + FIG8_CPU_STEPS
    print(f"fig8: block re-rollout: kernel launches during its {n_blk} control steps on the "
          f"card: {json.dumps(blk_counts)}; per control step: "
          f"{json.dumps({k: v / n_blk for k, v in blk_counts.items()})}", flush=True)
    require_launched("fig8_block_rerollout", blk_counts)

    one_goal = {k: v[:1] for k, v in goals_track.items()}
    control_step = lambda: run(st0, x0, t0_dev, one_goal, w)
    n_sub = int(round(FIG8_PERIOD * FIG8_SIM_HZ))
    sim_dt = 1.0 / FIG8_SIM_HZ
    sim_chain = cuda_sim_chain.make_sim_chain(prob.plant, 1, sim_dt)
    runner_args = (st0.x, st0.u, st0.K, st0.t0, cfg.dt, t0_dev, x0, n_sub)
    plan_step = make_step(prob.plant, cfg.integrator, cfg.dt)      # one qdd launch per step
    plant_step = make_step(prob.plant, 1, sim_dt)
    u_roll = st0.u[:cfg.num_time_steps - 1]
    # one forward pass as the solver runs it (sweep, rollout kernel, stage
    # cost, line search) on the gains of one backward pass from this state
    sv = ctrl._solver
    AB0, H0, g0 = _derivatives(sv.cfg, sv.step_jac, prob.cost.quad, st0.x, st0.u, goal0, w)
    backward_stage = lambda: backward_pass(
        sv.cfg, AB0, H0, g0, st0.P, st0.p, st0.d, st0.x, st0.x,
        torch.full((), sv.cfg.rho_init, device=dev), torch.full((), 1.0, device=dev))
    bp0 = backward_stage()
    stage_cost = lambda xk, uk, k: prob.cost.stage(xk, uk, k, goal0, w)
    J_prev = stage_cost(st0.x, st0.u, ks).sum()
    alphas = sv.alphas(dev, torch.float32)
    no_ignore = torch.full((), False, dtype=torch.bool, device=dev)

    def forward_stage():
        ro = forward_pass(sv.cfg, sv.step_fn, stage_cost, st0.x, st0.u, st0.d, bp0.K, bp0.du,
                          bp0.ApBK, bp0.Bdu, st0.x, alphas, fused_sim=sv.fused_sim)
        return line_search(sv.cfg, ro.J, ro.max_defect, alphas, bp0.dJexp, J_prev, no_ignore)

    stage_ms = {
        "forward pass (sweep + rollout kernel + stage cost + line search)": cuda_ms(
            forward_stage, 20),
        "backward pass": cuda_ms(backward_stage, 20),
        "control step (a 1-step loop call)": cuda_ms(control_step, 10),
        "MPC step (warm start + solve)": cuda_ms(lambda: ctrl.step(st0, x0, t0_dev, goal0, w), 10),
        "derivative stage": cuda_ms(lambda: _derivatives(
            ctrl._solver.cfg, ctrl._solver.step_jac, prob.cost.quad, st0.x, st0.u, goal0, w), 20),
        "cost H/g": cuda_ms(lambda: prob.cost.quad(st0.x, st0.u, ks, goal0, w), 20),
        "EE Jacobian": cuda_ms(lambda: prob.plant.ee_jac(st0.x[:, :7]), 20),
        "EE pose": cuda_ms(lambda: prob.plant.ee_pos(st0.x[:, :7]), 20),
        "AB": cuda_ms(lambda: ctrl._solver.step_jac(st0.x[:-1], st0.u[:-1]), 20),
        "warm start (shift + 63-step chain)": cuda_ms(lambda: ctrl._warm_start(st0, x0, s0), 20),
        "63-step rollout, chain kernel": cuda_ms(
            lambda: ctrl._chain.open_loop(x0, u_roll), 20),
        "63-step rollout, one launch per step (as before)": cuda_ms(
            lambda: cuda_sim_chain.open_loop_plain(plan_step, x0, u_roll), 5),
        f"{n_sub} substeps, chain kernel": cuda_ms(lambda: sim_chain.runner(*runner_args), 20),
        f"{n_sub} substeps, control law + one launch per step (as before)": cuda_ms(
            lambda: cuda_sim_chain.runner_plain(plant_step, sim_dt, *runner_args), 5),
    }
    print("fig8: ms per call: " + "; ".join(f"{k} {v:.3f}" for k, v in stage_ms.items()),
          flush=True)

    # the chain's trajectory-runner mode against its plain version (control
    # law + soa step in a Python loop) on the card, from the settled state
    plain_step = cuda_rollout._kuka_step(1, 0.0, 1, sim_dt)
    got_x, got_t = sim_chain.runner(*runner_args)
    ref_x, ref_t = cuda_sim_chain.runner_plain(plain_step, sim_dt, *runner_args)
    err, ok = compare("sim_chain", [got_x, got_t], [ref_x, ref_t])
    host_us, kernel_us = host_and_kernel_us(lambda: sim_chain.runner(*runner_args), 1000)
    runner = dict(max_abs_err=err, ok=ok, ms_runner=stage_ms[f"{n_sub} substeps, chain kernel"],
                  host_us_runner=host_us, kernel_us_runner=kernel_us)
    print(f"fig8: sim_chain runner ({n_sub} substeps from the settled state): max_abs_err "
          f"{err:.3e} ({'ok' if ok else 'OUT OF TOLERANCE'}); host {host_us:.2f} us per enqueue "
          f"(1000 enqueues, no sync), kernel alone {kernel_us:.2f} us (CUDA-graph replay)",
          flush=True)
    if not ok:
        fail("fig8: the chain's runner mode disagrees with its plain version")

    caches = {"fig-8 cold start": ctrl._warmup_solver(50).graphs, "fig-8 MPC step": ctrl.graphs,
              "fig-8 loop": run.graphs, "block re-rollout loop": run_blk.graphs}
    fleet = dict(ctrl=ctrl, run=run, settled=settled, w=w, x_init=x_init, goals_track=goals_track)
    return ({"fig8": fig8_counts, "fig8_block_rerollout": blk_counts}, control_step, runner,
            per_step, caches, fleet)


def batch_goals(torch, np, B, x_init, dev):
    """Scenario b's goal: the figure-8 at 10 s * b / B, as the goal dict with a
    leading B (x_target x_init, or zeros for None)."""
    from parallel_ddp_tpu_torch.presets import figure8_goal

    xyz = np.stack([figure8_goal(FIG8_TRACK_S * b / B, FIG8_TRACK_S)[0] for b in range(B)])
    ee = np.concatenate([xyz, np.zeros_like(xyz)], axis=1).astype(np.float32)
    xt = np.zeros((B, 14), np.float32) if x_init is None else np.tile(x_init, (B, 1))
    return {"ee_goal": torch.as_tensor(ee, device=dev), "x_target": torch.as_tensor(xt, device=dev)}


def batched_kernel_checks(torch, np, dev, kernels):
    """The rollout and Riccati kernels with a scenario axis at the WAFR shapes:
    at B = BATCH_CHECK against their plain versions (CPU tensors) and, bit for
    bit, against one launch per sampled scenario; timed at every B of
    BATCH_SIZES beside the roofline bound of that B.  The Jacobian and chain
    kernels at the flattened sample counts of every B, against their plain
    versions."""
    from parallel_ddp_tpu_torch.config import SolverConfig
    from parallel_ddp_tpu_torch.ops import cuda_rbd, cuda_riccati, cuda_rollout, cuda_sim_chain

    N, M, A, nx, nu = 64, 4, 16, 14, 7
    nf, nm = N // M, nx + nu
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rand = lambda *shape, s: torch.randn(shape, generator=gen, device=dev) * s
    cfg = SolverConfig(num_time_steps=N, m_blocks_b=M, m_blocks_f=M, num_alpha=A)
    alphas = torch.as_tensor(cfg.alphas(), device=dev)
    skip = torch.zeros((M, nf), dtype=torch.uint8, device=dev)
    skip[-1, -1] = 1                          # k = N-1
    ro_kw = dict(ee_type=1, gravity=0.0, integrator=1, dt=0.5 / (N - 1), m_blocks=M)
    bp = cuda_riccati.make_riccati_block_call(cfg, nx, nu)
    step = cuda_riccati.make_riccati_step(cfg, nx, nu)

    def rollout_inputs(B):
        return (rand(B, A, N, nx, s=0.3), rand(B, N, nu, s=1.0), rand(B, N, nu, nx, s=0.05),
                rand(B, N, nu, s=0.5), rand(B, N, nx, s=0.3), alphas, skip)

    def riccati_inputs(B):
        C = rand(B, M, nf, nm, nm, s=0.3)
        Cp = rand(B, M, nx, nx, s=0.3)
        AB = rand(B, M, nf, nx, nm, s=0.3)
        AB[:, -1, -1] = 0.0                   # the padded row of k = N-1
        rho = torch.rand(B, generator=gen, device=dev) * 1.8 + 0.2
        return (rho, Cp @ Cp.mT + torch.eye(nx, device=dev), rand(B, M, nx, s=0.5), AB,
                C @ C.mT + torch.eye(nm, device=dev), rand(B, M, nf, nm, s=0.5),
                rand(B, M, nf, nx, s=0.1), torch.arange(N, device=dev).reshape(M, nf))

    cases = {
        "rollout": (rollout_inputs, lambda a: cuda_rollout.kuka_rollout_cuda(*a, **ro_kw),
                    lambda a: cuda_rollout.kuka_rollout_plain(*a, **ro_kw),
                    lambda a, b: cuda_rollout.kuka_rollout_cuda(*(t[b] for t in a[:5]), *a[5:],
                                                               **ro_kw)),
        "riccati": (riccati_inputs, lambda a: bp(*a),
                    lambda a: cuda_riccati.run_block(step, a[0][:, None].expand(-1, M), *a[1:]),
                    lambda a, b: bp(*(t[b] for t in a[:7]), a[7])),
    }
    for name, (inputs, call, plain, one) in cases.items():
        r = next(k for k in kernels if k["name"] == name)
        args = inputs(BATCH_CHECK)
        got = call(args)
        if name == "riccati":
            ref = bp(*[t.cpu() for t in args])        # plain version on CPU tensors
            if bool(got[7].any()) or bool(ref[7].any()):
                fail("riccati batched: synthetic SPD inputs reported a Cholesky failure")
            got, ref = got[:7], ref[:7]
        else:
            ref = cuda_rollout.kuka_rollout_plain(*[t.cpu() for t in args], **ro_kw)
        err, ok = compare(name, got, [t.to(dev) for t in ref])
        same = all(torch.equal(g[b], o) for b in BATCH_SAMPLES
                   for g, o in zip(got, one(args, b)))
        times = []
        for B in BATCH_SIZES:
            a = args if B == BATCH_CHECK else inputs(B)
            out = call(a)
            ms = cuda_ms(lambda: call(a), BATCH_TIMED)
            bound = roofline(a, out, count_ops(lambda: plain(a)))
            r[f"ms_b{B}"], r[f"bound_ms_b{B}"] = ms, bound["bound_ms"]
            r[f"bytes_b{B}"], r[f"operations_b{B}"] = bound["bytes"], bound["operations"]
            times.append(f"B={B} {ms:.4f} ms (bound {bound['bound_ms']:.3e} ms by "
                         f"{bound['bound_by']}, {bound['bytes']} B, {bound['operations']} ops)")
            del a, out
        print(f"batched: {name} kernel at B={BATCH_CHECK}: max_abs_err {err:.3e} "
              f"({'ok' if ok else 'OUT OF TOLERANCE'}) against the plain version; scenarios "
              f"{list(BATCH_SAMPLES)} {'equal' if same else 'DIFFER FROM'} their own launches bit "
              f"for bit; {'; '.join(times)}", flush=True)
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ok"] = r["ok"] and ok
        if not (ok and same):
            fail(f"batched {name} kernel: plain tolerance {'ok' if ok else 'missed'}, "
                 f"per-scenario launches {'equal' if same else 'differ'}")
        torch.cuda.empty_cache()
    # the dynamics kernels take the scenarios' samples flattened (one program
    # a sample or chain: nothing to hold per scenario), at every B against
    # their plain versions: on CPU tensors at B = BATCH_CHECK, on the card's
    # tensors at the larger B (the CPU would take minutes there).  The
    # Jacobian and its Euler AB: B * 63 samples a derivative stage; the chain:
    # B * M blocks of Nf steps (the batched solve's initial rollout) and B
    # chains of N - 1 steps (the fleet step's warm start)
    dt = 0.5 / (N - 1)
    eye = lambda k, ref: torch.eye(k, device=ref.device).expand(len(ref), k, k)
    zero = lambda k, ref: torch.zeros(len(ref), k, k, device=ref.device)
    plain_ab = cuda_rbd.make_ab_composer(None, lambda xs, us: torch.cat(
        [torch.cat([zero(nu, xs), eye(nu, xs), zero(nu, xs)], dim=2),
         cuda_rbd.kuka_jac_qdd_plain(xs, us, 1, 0.0)[0]], dim=1), 1, dt, nx, nu)
    ab = cuda_rbd.make_kuka_ab(1, 0.0, 1, dt)
    chain_step = cuda_rollout._kuka_step(1, 0.0, 1, dt)
    chain_kw = dict(ee_type=1, gravity=0.0, integrator=1, dt=dt)
    plain_on = lambda B, args: [t.cpu() for t in args] if B == BATCH_CHECK else args
    r = next(k for k in kernels if k["name"] == "rbd_jac")
    rc = next(k for k in kernels if k["name"] == "sim_chain")
    times, chains, bad = [], [], []
    for B in BATCH_SIZES:
        x, u = rand(B * (N - 1), nx, s=0.5), rand(B * (N - 1), nu, s=2.0)
        out = cuda_rbd.kuka_jac_qdd_cuda(x, u, 1, 0.0)
        xr, ur = plain_on(B, (x, u))
        err, ok = compare("rbd_jac", out, [t.to(dev) for t in
                                           cuda_rbd.kuka_jac_qdd_plain(xr, ur, 1, 0.0)])
        ab_err, ab_ok = compare("rbd_jac", [ab(x, u)], [plain_ab(xr, ur).to(dev)])
        del xr, ur
        ms = cuda_ms(lambda: cuda_rbd.kuka_jac_qdd_cuda(x, u, 1, 0.0), BATCH_TIMED)
        ab_ms = cuda_ms(lambda: ab(x, u), BATCH_TIMED)
        bound = roofline((x, u), out, count_ops(lambda: cuda_rbd.kuka_jac_qdd_plain(x, u, 1, 0.0)))
        r[f"ms_b{B}"], r[f"ms_euler_ab_b{B}"] = ms, ab_ms
        r[f"bound_ms_b{B}"] = bound["bound_ms"]
        r[f"bytes_b{B}"], r[f"operations_b{B}"] = bound["bytes"], bound["operations"]
        r["max_abs_err"] = max(r["max_abs_err"], err, ab_err)
        r["ok"] = r["ok"] and ok and ab_ok
        if not (ok and ab_ok):
            bad.append(f"rbd_jac at B={B}")
        times.append(f"B={B} ({B * (N - 1)} samples) max_abs_err {err:.3e}, Euler AB {ab_err:.3e} "
                     f"({'ok' if ok and ab_ok else 'OUT OF TOLERANCE'}); {ms:.4f} ms, Euler AB "
                     f"{ab_ms:.4f} ms (bound {bound['bound_ms']:.3e} ms by {bound['bound_by']})")
        del x, u, out
        for lead, T in (((B, M), nf), ((B,), N - 1)):
            x0, uc = rand(*lead, nx, s=0.3), rand(*lead, T, nu, s=1.0)
            got = cuda_sim_chain.kuka_open_loop_cuda(x0, uc, **chain_kw)
            err, ok = compare("sim_chain", [got], [
                cuda_sim_chain.open_loop_plain(chain_step, *plain_on(B, (x0, uc))).to(dev)])
            rc["max_abs_err"] = max(rc["max_abs_err"], err)
            rc["ok"] = rc["ok"] and ok
            if not ok:
                bad.append(f"sim_chain at {lead} x T={T}")
            chains.append(f"{int(np.prod(lead))} chains x T={T}: max_abs_err {err:.3e} "
                          f"({'ok' if ok else 'OUT OF TOLERANCE'})")
            del x0, uc, got
    print(f"batched: rbd_jac kernel against its plain version (CPU tensors at B={BATCH_CHECK}, "
          f"the card's above): {'; '.join(times)}", flush=True)
    print(f"batched: sim_chain open loop against its plain version (CPU tensors at "
          f"B={BATCH_CHECK}, the card's above): {'; '.join(chains)}", flush=True)
    if bad:
        fail(f"batched: flattened dynamics kernels disagree with their plain versions: {bad}")
    torch.cuda.empty_cache()


def batched_stages(torch, dev, solver, cfg, x, u, goals):
    """ms of the stages of one batched iteration (eager, CUDA events), at the
    batch of x (B, N, n): where a batched solve's time goes."""
    from parallel_ddp_tpu_torch.config import weights_of, weights_tensor
    from parallel_ddp_tpu_torch.parallel.backward import backward_pass
    from parallel_ddp_tpu_torch.parallel.forward import forward_pass, forward_sweep
    from parallel_ddp_tpu_torch.solver import _derivatives, goal_dims, per_scenario

    B, N, n = x.shape
    w = weights_of(weights_tensor(None, dev), x)
    dims = goal_dims(goals)
    quad, stage = per_scenario(solver.cost.quad, dims), per_scenario(solver.cost.stage, dims)
    ks = torch.arange(N, device=dev)
    AB, H, g = _derivatives(cfg, solver.step_jac, quad, x, u, goals, w)
    zeros = x.new_zeros
    rho = torch.full((B,), cfg.rho_init, device=dev)
    back = lambda: backward_pass(cfg, AB, H, g, zeros(B, N, n, n), zeros(B, N, n), zeros(B, N, n),
                                 x, x, rho, torch.ones_like(rho))
    bp = back()
    alphas = solver.alphas(dev, x.dtype)
    stage_fn = lambda xk, uk, k: stage(xk, uk, k, goals, w)
    x_sw = forward_sweep(cfg, bp.ApBK, bp.Bdu, zeros(B, N, n), x, x, alphas)
    ms = {
        "derivative stage": cuda_ms(lambda: _derivatives(cfg, solver.step_jac, quad, x, u, goals,
                                                         w), 5),
        "  AB (Jacobian kernel)": cuda_ms(lambda: solver.step_jac(
            x[:, :-1].reshape(-1, n), u[:, :-1].reshape(-1, u.shape[-1])), 5),
        "  cost H/g (vmapped)": cuda_ms(lambda: quad(x, u, ks, goals, w), 5),
        "backward pass (Riccati kernel)": cuda_ms(back, 5),
        "forward pass": cuda_ms(lambda: forward_pass(
            cfg, solver.step_fn, stage_fn, x, u, zeros(B, N, n), bp.K, bp.du, bp.ApBK, bp.Bdu, x,
            alphas, fused_sim=solver.fused_sim), 5),
        "  sweep (63 baddbmm)": cuda_ms(lambda: forward_sweep(
            cfg, bp.ApBK, bp.Bdu, zeros(B, N, n), x, x, alphas), 5),
        "  rollout kernel": cuda_ms(lambda: solver.fused_sim(x_sw, u, bp.K, bp.du, x, alphas), 5),
        "  stage cost of the candidates (vmapped)": cuda_ms(
            lambda: stage(x_sw, x_sw[..., :u.shape[-1]], ks, goals, w), 5),
    }
    return ms


def hold_scenario(torch, np, label, solve, single, out, x0s, u0s, goals, b):
    """Scenario b of a batched cold solve `out` (`solve`'s replay on x0s,
    u0s and goals, a pytree with a leading B) against the same scenario
    solved alone by `single`: the same iterations and alphas, final J
    within SOLVE_RTOL, and the J trace within J_TRACE_FACTOR x the one-ulp
    rounding envelope.  Returns (largest relative J gap, its share of the
    envelope)."""
    from torch.utils import _pytree as pytree

    B = x0s.shape[0]
    pick = lambda sl: pytree.tree_map(lambda v: v[sl], goals)
    goal_b, x0, u0 = pick(b), x0s[b], u0s[b]
    one = single(x0, u0, goal_b, initial_rollout=True)
    it = int(one.iters)
    ga, oa = out.alpha_trace[b, :it + 1].cpu(), one.alpha_trace[:it + 1].cpu()
    gap = trace_gap(out.J_trace[b], one.J_trace, it)
    # witnesses that tell rounding from a fault: (a) B copies of scenario b,
    # each equal to the others and to scenario b of the mixed batch bit for
    # bit (a scenario's result depends on its own inputs and B alone); (b)
    # scenario b as a batch of 1, bit for bit the single graph (the batched
    # body and its vmapped cost are the single solve's); (c) the rounding
    # envelope: the single solve from controls moved by one ulp, against the
    # single solve.  What is left between the batch and the single solve is
    # what the glue's kernels round otherwise at another B, and it must stay
    # inside the envelope
    tile = lambda t: t[None].expand((B,) + t.shape).contiguous()
    copies = solve(tile(x0), tile(u0), pytree.tree_map(tile, goal_b))
    same = all(torch.equal(bits(t), bits(t[:1]).expand_as(bits(t)))
               and torch.equal(bits(t[0]), bits(s[b]))
               for t, s in zip(copies, out))
    del copies
    alone = solve(x0s[b:b + 1], u0s[b:b + 1], pick(slice(b, b + 1)))
    alone_same = all(torch.equal(bits(t[0]), bits(s)) for t, s in zip(alone, one))
    moved = single(x0, torch.nextafter(u0, torch.full_like(u0, float("inf"))), goal_b,
                   initial_rollout=True)
    env = trace_gap(moved.J_trace, one.J_trace, min(it, int(moved.iters)))
    moved_part = first_difference(moved.alpha_trace, one.alpha_trace, it)
    envelope = np.maximum(J_TRACE_FLOOR, np.maximum.accumulate(
        np.pad(env, (0, len(gap) - len(env)), mode="edge")))
    need = float(np.max(gap / envelope))
    print(f"{label}: scenario {b}: {it} iterations; relative J-trace gap to the single solve at "
          f"iterations {list(GAP_AT)}: mixed batch {at_iters(gap)}, one-ulp envelope "
          f"{at_iters(env)} (its alphas part at iteration {moved_part}); the gap reaches "
          f"{need:.3f} x the envelope's running largest (limit {J_TRACE_FACTOR:g}); alone as a "
          f"batch of 1 {'equal to' if alone_same else 'DIFFERENT FROM'} the single graph bit for "
          f"bit; {B} copies {'equal each other and the mixed batch' if same else 'DIFFER'} bit for "
          f"bit", flush=True)
    if not (same and alone_same):
        fail(f"{label} scenario {b}: {B} copies equal each other and the mixed batch: {same}; "
             f"alone as a batch of 1 equal to the single graph: {alone_same}")
    iters = int(out.iters[b])
    if iters != it or not torch.equal(ga, oa) or not np.isclose(
            float(out.J[b]), float(one.J), rtol=SOLVE_RTOL, atol=0.0) or need > J_TRACE_FACTOR:
        fail(f"{label} scenario {b} and its single solve disagree: iterations {iters} vs {it}, "
             f"alphas {ga.tolist()} vs {oa.tolist()}, J {float(out.J[b])} vs {float(one.J)}, "
             f"J-trace gap up to {need:.3f} x the envelope")
    return float(gap.max()), need


def batched_phase(torch, np, dev, cold, canon, fleet, kernels, card):
    """Scenario batching end to end: the batched solve (correctness at
    B = BATCH_CHECK, launches and throughput at every B of BATCH_SIZES), the
    fleet MPC step, and the control step with changed weights."""
    from parallel_ddp_tpu_torch.mpc.driver import MPCState
    from parallel_ddp_tpu_torch.parallel.sharding import make_batched_solver
    from parallel_ddp_tpu_torch.presets import kuka_ee
    from parallel_ddp_tpu_torch.solver import make_ilqr_solver

    t_phase = time.perf_counter()
    batched_kernel_checks(torch, np, dev, kernels)
    prob = kuka_ee()
    cfg = dataclasses.replace(prob.cfg, pallas_riccati=True, max_iter=BATCH_CHECK_ITERS)
    tile = lambda t, B: t[None].expand((B,) + t.shape).contiguous()

    # -- correctness at B = BATCH_CHECK: the sampled scenarios alone through
    #    the single solver's graph
    B = BATCH_CHECK
    x0s, u0s, goals = tile(cold.x, B), tile(cold.u, B), batch_goals(torch, np, B, None, dev)
    solve = make_batched_solver(prob.plant, prob.cost, cfg)
    solve(x0s, u0s, goals)                                         # the capture
    torch.cuda.synchronize()
    out, syncs = count_syncs(torch, lambda: solve(x0s, u0s, goals))
    reads = solve.solver.host_syncs
    iters = out.iters.cpu().numpy()
    J, J0 = out.J.cpu().numpy(), out.J_trace[:, 0].cpu().numpy()
    print(f"batched: WAFR solve at B={B} (tol_cost {cfg.tol_cost:g}, at most {cfg.max_iter} "
          f"iterations, from the cold solve's trajectory): iterations min {iters.min()}, median "
          f"{float(np.median(iters)):g}, max {iters.max()} ({len(set(iters.tolist()))} distinct); "
          f"J median {float(np.median(J)):.4f}; host reads {reads} (torch sync-debug count "
          f"{syncs})", flush=True)
    if reads or syncs:
        fail(f"batched solve synchronised with the host ({reads} reads, {syncs} syncs)")
    if not (np.all(np.isfinite(J)) and np.all(J <= J0)):
        fail("batched solve: non-finite J or J above J0")
    single = make_ilqr_solver(prob.plant, prob.cost, cfg)
    gaps, needs = zip(*(hold_scenario(torch, np, "batched", solve, single, out, x0s, u0s, goals, b)
                        for b in BATCH_SAMPLES))
    print(f"batched: scenarios {list(BATCH_SAMPLES)} equal their single solves (graph replays: "
          f"iterations, alphas, final J within rtol {SOLVE_RTOL}, J trace within "
          f"{J_TRACE_FACTOR:g} x the one-ulp envelope at every iteration; largest relative gap "
          f"{max(gaps):.2e}, largest share of the envelope {max(needs):.3f})", flush=True)
    del out
    torch.cuda.empty_cache()

    # -- launches and throughput of a batched 6-iteration solve at each B
    cfg6 = dataclasses.replace(cfg, max_iter=N_ITERS, tol_cost=0.0)
    solve6 = make_batched_solver(prob.plant, prob.cost, cfg6)
    rows, path_counts, per_b = [], None, {}
    for Bt in BATCH_SIZES:
        xs, us, gs = tile(cold.x, Bt), tile(cold.u, Bt), batch_goals(torch, np, Bt, None, dev)
        call = lambda: solve6(xs, us, gs)
        call()                                                     # the capture
        torch.cuda.synchronize()
        reset_counts()
        call()
        torch.cuda.synchronize()
        counts = read_counts()
        if path_counts is None:
            path_counts = counts
            require_launched("wafr_batched", counts)
        if not (counts["rbd_jac"] == counts["rollout"] == N_ITERS
                and counts["riccati"] >= N_ITERS) or counts != path_counts:
            fail(f"batched B={Bt}: launches {counts} (want {N_ITERS} of the Jacobian and the "
                 f"rollout kernel, {N_ITERS} or more of Riccati, as at B={BATCH_SIZES[0]})")
        times = event_times(call, BATCH_TIMED)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(BATCH_TIMED):
            call()
        end.record()
        torch.cuda.synchronize()
        share = start.elapsed_time(end) / ((time.perf_counter() - t0) * 1e3)
        ms = float(np.median(times))
        g = solve6.solver.graphs.stats()[-1]
        per_b[Bt] = dict(ms=ms, solves_per_s=Bt / ms * 1e3, nodes=g.nodes, pool_bytes=g.pool_bytes,
                         capture_s=g.seconds, busy=share)
        rows.append(f"B={Bt}: {ms:.3f} ms a batched solve (median of {BATCH_TIMED}, min "
                    f"{min(times):.3f}, max {max(times):.3f}), {Bt / ms * 1e3:.0f} solves/s; "
                    f"graph {g.nodes} nodes (bodies {list(g.body_nodes)}), pool {g.pool_bytes} B, "
                    f"captured in {g.seconds:.3f} s; stream busy {share:.3f}")
        if Bt == BATCH_STAGES:
            stage_ms = batched_stages(torch, dev, solve6.solver, cfg6, xs, us, gs)
        del xs, us, gs
        torch.cuda.empty_cache()
    print(f"batched: ms per call of the stages of one batched iteration at B={BATCH_STAGES} "
          f"(eager, CUDA events): " + "; ".join(f"{k.strip()} {v:.3f}" for k, v in
                                                 stage_ms.items()), flush=True)
    print(f"batched: launches of one batched {N_ITERS}-iteration solve (counted on the device), "
          f"the same at every B: {json.dumps(path_counts)}", flush=True)
    print(f"batched: {N_ITERS}-iteration WAFR solves (tol_cost 0) on {card}: " + "; ".join(rows),
          flush=True)

    # -- the fleet MPC step from the settled fig-8 state
    ctrl, run, w = fleet["ctrl"], fleet["run"], fleet["w"]
    st_s, x_s, t_s = fleet["settled"]
    Bf = BATCH_CHECK
    x_act = tile(x_s, Bf)
    goals_f = batch_goals(torch, np, Bf, fleet["x_init"], dev)
    t0s = torch.full((Bf,), t_s, dtype=torch.float32, device=dev)
    sts = ctrl.init_state_batch(x_act, t0s, goals_f, w)
    t_now = t0s + FIG8_PERIOD
    step = lambda: ctrl.step_batch(sts, x_act, t_now, goals_f, w)
    step()                                                         # the capture
    torch.cuda.synchronize()
    (new, info), syncs = count_syncs(torch, step)
    reads = ctrl.host_syncs
    step_ms = event_times(step, BATCH_TIMED)
    one_st, one_info = ctrl.step(MPCState(*(a[0] for a in sts)), x_act[0], t_now[0],
                                 {k: v[0] for k, v in goals_f.items()}, w)
    acc = info.accepted.cpu().numpy()
    print(f"batched: fleet MPC step at B={Bf} (init_state_batch from the settled fig-8 state, "
          f"goals along the path): {float(np.median(step_ms)):.3f} ms a replay (median of "
          f"{BATCH_TIMED}), {Bf / float(np.median(step_ms)) * 1e3:.0f} control steps/s; accept "
          f"rate {acc.mean():.3f}; host reads {reads} (torch sync-debug count {syncs}); scenario 0 "
          f"J {float(info.J[0]):.5f} accepted {bool(info.accepted[0])} shift "
          f"{int(info.shift_steps[0])}, single step J {float(one_info.J):.5f} accepted "
          f"{bool(one_info.accepted)} shift {int(one_info.shift_steps)}", flush=True)
    if reads or syncs:
        fail(f"fleet MPC step synchronised with the host ({reads} reads, {syncs} syncs)")
    if not (bool(info.accepted[0]) == bool(one_info.accepted)
            and int(info.shift_steps[0]) == int(one_info.shift_steps)
            and np.isclose(float(info.J[0]), float(one_info.J), rtol=SOLVE_RTOL, atol=0.0)):
        fail("fleet MPC step: scenario 0 and the single step disagree")

    # -- queue C 1: the control step with changed weights, no new capture
    one_goal = {k: v[:1] for k, v in fleet["goals_track"].items()}
    t_dev = torch.full((), t_s, dtype=torch.float32, device=dev)
    before = len(run.graphs)
    a = run(st_s, x_s, t_dev, one_goal, w)
    b = run(st_s, x_s, t_dev, one_goal, w._replace(q_ee1=0.5 * w.q_ee1, qf_ee1=0.5 * w.qf_ee1))
    print(f"batched: fig-8 control step with the EE weights halved: J {float(a.J[0]):.5f} -> "
          f"{float(b.J[0]):.5f}; captures of the loop {before} -> {len(run.graphs)}", flush=True)
    if len(run.graphs) != before or torch.equal(a.J, b.J):
        fail("a weight change made a new capture or did not take effect")
    # -- a B = 2 batch on CPU tensors (plain versions, host loop) against the
    #    card (last: the CPU solves take the longest): the solve phase's
    #    canonical cold start toward its first two goals, where a single
    #    solve's GPU and CPU traces agree within SOLVE_RTOL (on the fig-8
    #    inputs below they part by more, a single solve as much as the batch)
    args2 = (torch.stack([canon["x0"]] * 2), torch.stack([canon["u0"]] * 2),
             {k: torch.stack([g[k] for g in canon["goals"]]) for k in canon["goals"][0]})
    kw = dict(initial_rollout=True, iter_limit=BATCH_CPU_ITERS)
    cpu_solver = make_ilqr_solver(prob.plant, prob.cost, cfg)
    gpu2 = solve.solver.solve_batch(*args2, **kw)
    cpu2 = cpu_solver.solve_batch(args2[0].cpu(), args2[1].cpu(),
                                  {k: v.cpu() for k, v in args2[2].items()}, **kw)
    for i, b in enumerate(("goal 0", "goal 1")):
        ga, ca = gpu2.alpha_trace[i].cpu(), cpu2.alpha_trace[i]
        gj = gpu2.J_trace[i, :BATCH_CPU_ITERS + 1].cpu().numpy()
        cj = cpu2.J_trace[i, :BATCH_CPU_ITERS + 1].numpy()
        print(f"batched: B=2 batch, scenario {b}: GPU J {gj.tolist()} alphas "
              f"{ga[1:BATCH_CPU_ITERS + 1].tolist()}; CPU J {cj.tolist()} alphas "
              f"{ca[1:BATCH_CPU_ITERS + 1].tolist()}", flush=True)
        if not torch.equal(ga, ca) or not np.isclose(float(gpu2.J[i]), float(cpu2.J[i]),
                                                     rtol=SOLVE_RTOL, atol=0.0):
            fail(f"batched B=2 GPU and CPU solves disagree (scenario {b}: alphas, or final J "
                 f"beyond rtol {SOLVE_RTOL})")
    print(f"batched: a B=2 batch ({BATCH_CPU_ITERS} iterations) agrees with CPU tensors "
          f"(alphas, final J within rtol {SOLVE_RTOL})", flush=True)
    # the same on the fig-8 inputs of the correctness batch (its scenarios 0
    # and 1), beside scenario 0 solved alone on the card and on CPU tensors:
    # how far the card parts from the CPU at one scenario tells whether the
    # batch's part is its own
    goal0 = {k: v[0] for k, v in goals.items()}
    gpu8 = solve.solver.solve_batch(x0s[:2], u0s[:2], {k: v[:2] for k, v in goals.items()}, **kw)
    cpu8 = cpu_solver.solve_batch(x0s[:2].cpu(), u0s[:2].cpu(),
                                  {k: v[:2].cpu() for k, v in goals.items()}, **kw)
    one_gpu = single(cold.x, cold.u, goal0, **kw)
    one_cpu = cpu_solver(cold.x.cpu(), cold.u.cpu(), {k: v.cpu() for k, v in goal0.items()}, **kw)
    it8 = BATCH_CPU_ITERS
    readings = {
        "batch GPU vs batch CPU": trace_gap(gpu8.J_trace[0].cpu(), cpu8.J_trace[0], it8),
        "single GPU vs single CPU": trace_gap(one_gpu.J_trace.cpu(), one_cpu.J_trace, it8),
        "batch GPU vs single GPU": trace_gap(gpu8.J_trace[0], one_gpu.J_trace, it8),
        "batch CPU vs single CPU": trace_gap(cpu8.J_trace[0], one_cpu.J_trace, it8),
    }
    alphas8 = [t[:it8 + 1].tolist() for t in (gpu8.alpha_trace[0].cpu(), cpu8.alpha_trace[0],
                                              one_gpu.alpha_trace.cpu(), one_cpu.alpha_trace)]
    cpu_bits = all(torch.equal(bits(t[0]), bits(s)) for t, s in zip(cpu8, one_cpu))
    print(f"batched: fig-8 inputs, scenario 0, {it8} iterations: relative J-trace gaps by "
          f"iteration: " + "; ".join(f"{k} {at_iters(v)}" for k, v in readings.items())
          + f"; alphas batch GPU / batch CPU / single GPU / single CPU {alphas8}; the CPU batch "
          f"{'equals' if cpu_bits else 'DIFFERS FROM'} the CPU single solve bit for bit",
          flush=True)
    own = readings["batch GPU vs batch CPU"] / np.maximum(
        J_TRACE_FLOOR, readings["single GPU vs single CPU"])
    if not (cpu_bits and all(a == alphas8[0] for a in alphas8) and np.all(own <= FIG8_OWN_GAP)):
        fail(f"batched B=2 on the fig-8 inputs: the card parts from the CPU otherwise than a single "
             f"solve does (CPU batch bit for bit the single: {cpu_bits}; alphas {alphas8}; "
             f"gap up to {float(own.max()):.3f} x the single solve's, limit {FIG8_OWN_GAP:g})")
    print(f"batched: phase took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return path_counts, per_b, {"batched solver": solve6.solver.graphs}


def main():
    t_start = time.perf_counter()
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"import: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a CUDA GPU")
    try:
        from parallel_ddp_tpu_torch.ops import build
    except ImportError as e:
        fail(f"the port is not importable from here: {e}")
    # full float32: TF32 breaks the Riccati and RBD math (the solver checks)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    try:
        path, nvcc_s, log = build.build()
        build.library()
    except RuntimeError as e:
        fail(f"build: {e}")
    ptxas = ptxas_summary(log)
    print(f"build: {path.name} in {time.perf_counter() - t0:.1f} s (nvcc {nvcc_s:.1f} s); "
          f"ptxas: {' | '.join(ptxas)}", flush=True)
    # the forward-dynamics kernels on the thread-group core spill nothing
    group = [ln for ln in ptxas if ln.startswith(("qdd_kernel", "sim_chain_kernel"))]
    print(f"build: ptxas of the qdd and chain kernels: {' | '.join(group)}", flush=True)
    spills = [ln for ln in group if re.search(r"[1-9]\d* bytes spill", ln)]
    if spills or not group:
        fail(f"build: the qdd / chain kernels spill registers or were not reported: {spills}")
    # the launch counters that graphs increment on the device, one per wrapper
    # (the wrappers' modules register them when imported)
    from parallel_ddp_tpu_torch.ops import cuda_rbd, cuda_riccati, cuda_rollout, cuda_sim_chain  # noqa: F401

    build.prepare_counters(dev)

    kernels = kernel_phase(torch, np, dev)
    if sys.argv[1:] == ["--kernels-only"]:      # a short run while working on a kernel
        print("stopped after the kernel phase (--kernels-only): no result line", flush=True)
        return
    solver, cold, goal, launches, canon = solve_phase(torch, np, dev)
    median_ms, warm_solve, per_solve = timing_phase(torch, np, dev, solver, cold, goal)
    plant_launches, plant_summary = plants_phase(torch, np, dev, card)
    urdf_launches, urdf_summary = urdf_phase(torch, np, dev, card, median_ms)
    al_launches, al_summary, al_caches = constraints_phase(torch, np, dev, card)
    fig8_launches, control_step, runner, per_step, fig8_caches, fleet = fig8_phase(
        torch, np, dev, card)
    batched_launches, per_b, batched_caches = batched_phase(torch, np, dev, cold, canon, fleet,
                                                            kernels, card)
    caches = {"WAFR solver": solver.graphs, **al_caches, **fig8_caches, **batched_caches}
    chain = next(r for r in kernels if r["name"] == "sim_chain")
    chain["max_abs_err"] = max(chain["max_abs_err"], runner.pop("max_abs_err"))
    chain["ok"] = chain["ok"] and runner.pop("ok")
    chain.update(runner)
    # the WHILE trips of one call, from the launch counters: an iteration
    # runs one Jacobian launch, a rho attempt one Riccati launch
    trips = lambda c: (c["rbd_jac"], c["riccati"] - c["rbd_jac"])
    reset_counts()
    control_step()
    torch.cuda.synchronize()
    step_counts = read_counts()
    replay_line(torch, f"warm {N_ITERS}-iteration solve", warm_solve,
                solver.graphs.stats()[-1], trips(per_solve))
    replay_line(torch, "fig-8 control step (a 1-step loop call)", control_step,
                fig8_caches["fig-8 loop"].stats()[0], trips(step_counts))
    # last: once the profiler has attached to the card, launches may cost
    # more for the rest of the process
    profile_line(torch, f"replayed warm {N_ITERS}-iteration solve", warm_solve)
    profile_line(torch, "replayed fig-8 control step", control_step)
    print("graphs: " + "; ".join(
        f"{g.label} ({where}): captured and instantiated in {g.seconds:.3f} s, {g.nodes} nodes "
        f"(WHILE bodies {list(g.body_nodes)}), pool {g.pool_bytes} B"
        for where, cache in caches.items() for g in cache.stats()),
        flush=True)

    # launches: the kernel's count on the path LAUNCHES_FROM names (the fig-8
    # closed loop where that runs it); launches_<path>: every path's own count
    by_path = {"wafr_solve": launches, **plant_launches, **urdf_launches, **al_launches,
               **fig8_launches,
               "wafr_batched": batched_launches}
    line = {"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces")}
        | {"launches": by_path[LAUNCHES_FROM[r["name"]]][r["name"]],
           "launches_from": LAUNCHES_FROM[r["name"]], "max_abs_err": r["max_abs_err"],
           "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
           "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        | {k: v for k, v in r.items()
           if k.startswith(("ms_", "plain_ms_", "bound_ms_", "bound_by_", "max_abs_err_",
                            "host_us", "kernel_us", "bytes", "operations"))}
        | {f"launches_{path}": counts[r["name"]] for path, counts in by_path.items()}
        | {"launches_per_warm_solve": per_solve[r["name"]],
           "launches_per_control_step": per_step[r["name"]]}
        for r in kernels]}
    print(f"solve: median {median_ms:.3f} ms per warm {N_ITERS}-iteration solve on {card}",
          flush=True)
    print("plants: " + "; ".join(
        f"{name} {v['warm_ms']:.3f} ms a warm {N_ITERS}-iteration re-solve, iteration body "
        f"{v['body_nodes'][0]} nodes" for name, v in plant_summary.items()) + f" on {card}",
        flush=True)
    print(f"urdf: iiwa-14 URDF on the spatial-algebra core: {urdf_summary['warm_ms']:.3f} ms a "
          f"warm {N_ITERS}-iteration re-solve ({urdf_summary['warm_ms'] / median_ms:.1f} x the "
          f"kernel-backed Kuka's {median_ms:.3f} ms), iteration body "
          f"{urdf_summary['body_nodes'][0]} nodes, graph {urdf_summary['nodes']} nodes captured in "
          f"{urdf_summary['capture_s']:.2f} s; riccati {urdf_summary['launches']['riccati']} "
          f"launches a re-solve on {card}", flush=True)
    print(f"constraints: inner-solve replay {al_summary['inner_ms']['cold']:.3f} ms cold, "
          f"{al_summary['inner_ms']['warm']:.3f} ms warm; constrained batched B={AL_BATCH} "
          f"{al_summary['batched_ms']:.3f} ms; AL MPC period {al_summary['period_ms']:.3f} ms "
          f"(median) on {card}", flush=True)
    print("batched: " + "; ".join(f"B={B} {v['ms']:.3f} ms a {N_ITERS}-iteration batched solve, "
                                  f"{v['solves_per_s']:.0f} solves/s" for B, v in per_b.items())
          + f" on {card}", flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(line), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
