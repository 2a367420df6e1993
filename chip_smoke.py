#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (`parallel_ddp_tpu_torch`) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero):
  1. device  — a CUDA device is required (there is no CPU fallback); prints
               the card's name and power limit as nvidia-smi reports them.
  2. build   — compiles the CUDA kernels of `parallel_ddp_tpu_torch/csrc`.
  3. kernels — each kernel against its plain PyTorch version on the card, on
               seeded inputs at the main path's shapes, within a stated
               tolerance; and each one's time against the plain version's.
  4. solve   — the main path: the WAFR Kuka iiwa-14 end-effector solve
               (N=64, 4+4 blocks, 16 alphas, Euler, gravity-compensated) with
               the fused Riccati sweep, cold then three warm re-solves along
               the figure-8 goal; every kernel must have launched during it;
               the cold solve is repeated on CPU tensors (plain versions) and
               the two traces must agree.
  5. timing  — median of 20 warm 6-iteration re-solves (the first warm
               re-solve, repeated; CUDA events).
Then one JSON line with every kernel's numbers, the card line, and last
{"ok": true, "device": {...}}.

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
N_WARM = 3           # warm re-solves along the figure-8 after the cold solve
N_TIMED = 20         # warm solves in the timing median
MPC_DT = 0.01        # figure-8 goal step between re-solves (100 Hz replanning)

# Kernel vs plain version on the card, both float32 on the same inputs.  The
# two compute the same formulas in another order: nvcc contracts a*b+c into
# fused multiply-adds and sums in its own order, while the plain versions run
# PyTorch's separate kernels (and torch.func's forward-mode rules for the
# Jacobian).  Allowed: |kernel - plain| <= RTOL*|plain| + ATOL*max|plain|.
TOL = {
    # ~2k-operation chain ending in a Cholesky solve of the 7x7 mass matrix,
    # whose condition number (~1e3) amplifies float32 rounding (~1e-7)
    "rbd_jac": (1e-3, 1e-4),
    # 16 dependent integration steps with state feedback: rounding compounds
    "rollout": (1e-4, 1e-5),
    # 16 dependent Riccati steps of 14x21 products and a 7x7 Cholesky
    "riccati": (1e-4, 1e-5),
}
# GPU (kernels) vs CPU (plain versions) solve: the same accept/reject and
# alpha decisions, and J within this relative tolerance (float32 rounding of
# two different summation orders over 6 iterations of a chaotic problem)
SOLVE_RTOL = 1e-3


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
            name = m.group(2)[: int(m.group(1))]
        elif name and ("spill" in ln or "registers" in ln):
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


def kernel_phase(torch, np, dev):
    """Each kernel vs its plain version at the main path's shapes."""
    from parallel_ddp_tpu_torch.config import SolverConfig
    from parallel_ddp_tpu_torch.ops import cuda_rbd, cuda_riccati, cuda_rollout

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
    results.append(dict(
        name="rbd_jac", route="cuda", source="parallel_ddp_tpu_torch/csrc/rbd_jac.cu",
        replaces="parallel_ddp_tpu/ops/pallas_rbd.py:48", max_abs_err=err, ok=ok,
        ms=cuda_ms(lambda: cuda_rbd.kuka_jac_qdd_cuda(x, u, 1, 0.0), 50),
        plain_ms=cuda_ms(lambda: cuda_rbd.kuka_jac_qdd_plain(x, u, 1, 0.0), 5)))

    # -- fused rollout: 16 alphas x 4 blocks, Nf = 16; Euler, plus one RK3 case
    x_sw = f32(rng.normal(0, 0.3, (A, N, nx)))
    uu = f32(rng.normal(0, 1.0, (N, nu)))
    K = f32(rng.normal(0, 0.05, (N, nu, nx)))
    du = f32(rng.normal(0, 0.5, (N, nu)))
    xp = f32(rng.normal(0, 0.3, (N, nx)))
    alphas = f32(SolverConfig(num_alpha=A, alpha_base=0.5).alphas())
    rollout_err, rollout_ok = 0.0, True
    for integ in (1, 3):
        fused = cuda_rollout.make_kuka_fused_rollout(1, 0.0, integ, dt, N, M, A)
        got = fused(x_sw, uu, K, du, xp, alphas)
        cpu = [t.cpu() for t in (x_sw, uu, K, du, xp, alphas)]
        ref = fused(*cpu)                     # plain version on CPU tensors
        e, o = compare("rollout", got, [r.to(dev) for r in ref])
        print(f"kernels: rollout integrator {integ}: max_abs_err {e:.3e} "
              f"({'ok' if o else 'OUT OF TOLERANCE'})", flush=True)
        rollout_err, rollout_ok = max(rollout_err, e), rollout_ok and o
    skip = torch.zeros((M, N // M), dtype=torch.uint8, device=dev)
    skip[-1, -1] = 1                          # k = N-1
    ro_args = (x_sw, uu, K, du, xp, alphas, skip)
    ro_kw = dict(ee_type=1, gravity=0.0, integrator=1, dt=dt, m_blocks=M)
    results.append(dict(
        name="rollout", route="cuda", source="parallel_ddp_tpu_torch/csrc/rollout.cu",
        replaces="parallel_ddp_tpu/ops/pallas_rollout.py:76", max_abs_err=rollout_err,
        ok=rollout_ok,
        ms=cuda_ms(lambda: cuda_rollout.kuka_rollout_cuda(*ro_args, **ro_kw), 50),
        plain_ms=cuda_ms(lambda: cuda_rollout.kuka_rollout_plain(*ro_args, **ro_kw), 3)))

    # -- fused Riccati: 4 lanes x 16 steps, n = 14, m = 7, synthetic SPD inputs
    cfg = SolverConfig(num_time_steps=N, m_blocks_b=M, m_blocks_f=M, num_alpha=A)
    nm = nx + nu
    C = rng.normal(0, 0.3, (N, nm, nm))
    H = f32(np.einsum("kij,klj->kil", C, C) + np.eye(nm)).reshape(M, N // M, nm, nm)
    Cp = rng.normal(0, 0.3, (M, nx, nx))
    seeds_P = f32(np.einsum("kij,klj->kil", Cp, Cp) + np.eye(nx))
    seeds_p = f32(rng.normal(0, 0.5, (M, nx)))
    AB = np.concatenate([rng.normal(0, 0.3, (N - 1, nx, nm)), np.zeros((1, nx, nm))])
    AB = f32(AB).reshape(M, N // M, nx, nm)
    g = f32(rng.normal(0, 0.5, (M, N // M, nm)))
    d = f32(rng.normal(0, 0.1, (M, N // M, nx)))
    k_blk = torch.arange(N, device=dev).reshape(M, N // M)
    rho = torch.full((), 1.0, device=dev)
    bp = cuda_riccati.make_riccati_block_call(cfg, nx, nu)
    args = (rho, seeds_P, seeds_p, AB, H, g, d, k_blk)
    got = bp(*args)
    ref = bp(*[a.cpu() for a in args])        # plain version on CPU tensors
    if bool(got[7]) or bool(ref[7]):
        fail("riccati: synthetic SPD inputs reported a Cholesky failure")
    err, ok = compare("riccati", got[:7], [r.to(dev) for r in ref[:7]])
    step = cuda_riccati.make_riccati_step(cfg, nx, nu)
    results.append(dict(
        name="riccati", route="cuda", source="parallel_ddp_tpu_torch/csrc/riccati.cu",
        replaces="parallel_ddp_tpu/ops/pallas_riccati.py:137", max_abs_err=err, ok=ok,
        ms=cuda_ms(lambda: bp(*args), 50),
        plain_ms=cuda_ms(lambda: cuda_riccati.run_block(
            step, rho.expand(M), seeds_P, seeds_p, AB, H, g, d, k_blk), 3)))

    for r in results:
        print(f"kernels: {r['name']}: max_abs_err {r['max_abs_err']:.3e} "
              f"(rtol {TOL[r['name']][0]:g}, atol {TOL[r['name']][1]:g} x max|plain|) "
              f"{'ok' if r['ok'] else 'OUT OF TOLERANCE'}; "
              f"{r['ms']:.4f} ms vs plain {r['plain_ms']:.3f} ms", flush=True)
    bad = [r["name"] for r in results if not r["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    return results


def solve_phase(torch, np, dev):
    """The main path, cold + warm, with the launch counters."""
    from parallel_ddp_tpu_torch.ops import cuda_rbd, cuda_riccati, cuda_rollout
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

    # warm-up solve: builds every per-device cache (constants, alphas)
    solver(torch.as_tensor(x0, device=dev), torch.as_tensor(u0, device=dev),
           ee_goal(goal0, device=dev), initial_rollout=True)
    torch.cuda.synchronize()

    counters = (cuda_rbd.kuka_jac_qdd_cuda, cuda_rollout.kuka_rollout_cuda,
                cuda_riccati.riccati_cuda)
    for c in counters:
        c.launches = 0
    outs = [solver(torch.as_tensor(x0, device=dev), torch.as_tensor(u0, device=dev),
                   ee_goal(goals[0], device=dev), initial_rollout=True)]
    for i in range(1, N_WARM + 1):
        prev = outs[-1]
        outs.append(solver(prev.x, prev.u, ee_goal(goals[i], device=dev),
                           P0=prev.P, p0=prev.p, d0=prev.d, initial_rollout=False))
    torch.cuda.synchronize()
    launches = {"rbd_jac": counters[0].launches, "rollout": counters[1].launches,
                "riccati": counters[2].launches}
    print(f"solve: kernel launches during the cold + {N_WARM} warm solves: "
          f"{json.dumps(launches)}", flush=True)
    if min(launches.values()) <= 0:
        fail(f"a kernel of the main path never launched: {launches}")

    for i, out in enumerate(outs):
        jt = out.J_trace.cpu().numpy()[: out.iters + 1]
        at = out.alpha_trace.cpu().numpy()[1: out.iters + 1]
        kind = "cold" if i == 0 else f"warm{i}"
        print(f"solve: {kind}: J {np.array2string(jt, precision=4)} alphas {at.tolist()} "
              f"max_defect {float(out.max_defect):.3e}", flush=True)
        if not np.all(np.isfinite(jt)):
            fail(f"{kind} solve: non-finite J")
        if np.any(np.diff(jt) > 0):
            fail(f"{kind} solve: J increased")
    if not outs[0].J_trace[outs[0].iters] < outs[0].J_trace[0]:
        fail("cold solve did not reduce J below J0")

    # the same cold solve on CPU tensors: the plain versions of every kernel
    cpu = make_ilqr_solver(prob.plant, prob.cost, cfg)(
        torch.as_tensor(x0), torch.as_tensor(u0), ee_goal(goals[0]), initial_rollout=True)
    gj = outs[0].J_trace.cpu().numpy()[: outs[0].iters + 1]
    cj = cpu.J_trace.numpy()[: cpu.iters + 1]
    ga = outs[0].alpha_trace.cpu().numpy()[: outs[0].iters + 1]
    ca = cpu.alpha_trace.numpy()[: cpu.iters + 1]
    print(f"solve: cpu (plain) cold: J {np.array2string(cj, precision=4)} "
          f"alphas {ca[1:].tolist()}", flush=True)
    if ga.shape != ca.shape or not np.array_equal(ga, ca) or not np.allclose(
            gj, cj, rtol=SOLVE_RTOL, atol=0.0):
        fail(f"GPU and CPU cold solves disagree (alphas {ga.tolist()} vs {ca.tolist()}, "
             f"rtol {SOLVE_RTOL})")
    print(f"solve: GPU and CPU traces agree (same alphas, J within rtol {SOLVE_RTOL}); "
          f"host syncs per solve: {solver.host_syncs} for {outs[-1].iters} iterations",
          flush=True)
    return solver, outs[0], goals[1], launches


def timing_phase(torch, np, dev, solver, cold, goal):
    """The first warm re-solve (from the cold solve's output toward the next
    figure-8 goal), repeated: one MPC step's solve."""
    from parallel_ddp_tpu_torch.presets import ee_goal

    g = ee_goal(goal, device=dev)

    def one():
        return solver(cold.x, cold.u, g, P0=cold.P, p0=cold.p, d0=cold.d)

    for _ in range(3):
        one()
    # the syncs torch itself reports for one warm solve, beside the count
    # the solver keeps
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        one()
    torch.cuda.set_sync_debug_mode(0)
    torch_syncs = sum("synchroniz" in str(w.message) for w in caught)
    times = []
    for _ in range(N_TIMED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        one()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    print(f"timing: warm {N_ITERS}-iteration solve: median {float(np.median(times)):.3f} ms, "
          f"min {min(times):.3f}, max {max(times):.3f} over {N_TIMED} solves; "
          f"host syncs {solver.host_syncs} (torch sync-debug count {torch_syncs})", flush=True)
    return float(np.median(times))


def main():
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
    print(f"build: {path.name} in {time.perf_counter() - t0:.1f} s (nvcc {nvcc_s:.1f} s); "
          f"ptxas: {' | '.join(ptxas_summary(log))}", flush=True)

    kernels = kernel_phase(torch, np, dev)
    solver, cold, goal, launches = solve_phase(torch, np, dev)
    median_ms = timing_phase(torch, np, dev, solver, cold, goal)

    line = {"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces")}
        | {"launches": launches[r["name"]], "max_abs_err": r["max_abs_err"],
           "ms": r["ms"], "plain_ms": r["plain_ms"]}
        for r in kernels]}
    print(f"solve: median {median_ms:.3f} ms per warm {N_ITERS}-iteration solve on {card}",
          flush=True)
    print(json.dumps(line), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
