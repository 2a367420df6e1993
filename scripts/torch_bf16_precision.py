#!/usr/bin/env python3
"""How far the bfloat16 forward path departs from float32, on the CPU.

    python3 scripts/torch_bf16_precision.py [--jax] [--jax-soa]   (from the root of a checkout)

Prints, for the port (parallel_ddp_tpu_torch) on CPU tensors:
  * one bfloat16 integrator step against float32 on tests/test_bf16.py:74's
    seeded Kuka states (max |err| / max(|f32|, 1)): the scalar-channel core
    (the "cuda" core's plain version, bfloat16 throughout) and the
    spatial-algebra core (float32 after the cast, as the JAX package's);
  * tests/test_bf16.py:42's solves (kuka_ee N = 16, 2 blocks, 4 alphas,
    6 iterations, tol_cost 0, both flags against float32) on both cores:
    the alpha traces, the largest J gap and the largest |x - x_f32|;
  * the AL pendulum swing-up (|u| <= 6, 3 outer x 20 inner, tol_cost 0):
    the violation after each outer iteration, float32, both flags and each
    flag alone.
With --jax, the same step, solves and AL loops on the JAX package's CPU core
(the spatial-algebra one), and its WAFR cold solve (kuka_ee(), 6 iterations
from chip_smoke.py's cold start) in both precisions; with --jax-soa, the JAX
package's scalar-channel core's bfloat16 step (its XLA CPU compile takes ~5
minutes).
"""

import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from parallel_ddp_tpu_torch import constraints  # noqa: E402
from parallel_ddp_tpu_torch.ops.integrators import make_bf16_step, make_step  # noqa: E402
from parallel_ddp_tpu_torch.presets import ee_goal, kuka_ee, pendulum_swingup  # noqa: E402
from parallel_ddp_tpu_torch.solver import make_ilqr_solver  # noqa: E402

N, M, A = 16, 2, 4
GOAL = (0.3, -0.3, 0.9)
BOTH = dict(bf16_rollout=True, bf16_cost=True)
AL_VARIANTS = (("float32", {}), ("both flags", BOTH), ("bf16_cost", dict(bf16_cost=True)),
               ("bf16_rollout", dict(bf16_rollout=True)))


def inputs():
    rng = np.random.default_rng(0)
    return (rng.normal(0, 0.5, (32, 14)).astype(np.float32),
            rng.normal(0, 2.0, (32, 7)).astype(np.float32))


def step_gap(f32, f16):
    return float((np.abs(f16 - f32) / np.maximum(np.abs(f32), 1.0)).max())


def port():
    x, u = inputs()
    for core in ("cuda", "rbd"):
        prob = kuka_ee(num_time_steps=N, m_blocks=M, num_alpha=A, core=core)
        step = make_step(prob.plant, prob.cfg.integrator, prob.cfg.dt)
        xt, ut = torch.as_tensor(x), torch.as_tensor(u)
        print(f"port step, {core} core: bfloat16 against float32 "
              f"{step_gap(step(xt, ut).numpy(), make_bf16_step(step)(xt, ut).numpy()):.4f}",
              flush=True)
        cfg = dataclasses.replace(prob.cfg, max_iter=6, tol_cost=0.0)
        args = (torch.zeros(N, 14), torch.zeros(N, 7), ee_goal(GOAL, device="cpu"))
        o32 = make_ilqr_solver(prob.plant, prob.cost, cfg)(*args, initial_rollout=True)
        o16 = make_ilqr_solver(prob.plant, prob.cost, dataclasses.replace(cfg, **BOTH))(
            *args, initial_rollout=True)
        report(f"port solve, {core} core", o32, o16)
    prob = pendulum_swingup(num_time_steps=64, total_time=2.0, m_blocks=2, num_alpha=8)
    con = constraints.BoxConstraints(n_state=2, n_ctrl=1, u_min=[-6.0], u_max=[6.0])
    for name, flags in AL_VARIANTS:
        cfg = dataclasses.replace(prob.cfg, max_iter=20, tol_cost=0.0, **flags)
        _, info = constraints.make_al_solver(prob.plant, prob.cost, cfg, con,
                                             constraints.ALConfig(max_outer=3))(
            torch.zeros(64, 2), torch.zeros(64, 1), torch.tensor([np.pi, 0.0]))
        print(f"port AL pendulum, {name}: violations {[round(v, 5) for v in info['violations']]}",
              flush=True)


def jax_side(soa):
    import jax
    import jax.numpy as jnp

    from parallel_ddp_tpu.ops.integrators import make_step as ref_make_step
    from parallel_ddp_tpu.presets import ee_goal as ref_ee_goal
    from parallel_ddp_tpu.presets import kuka_ee as ref_kuka_ee
    from parallel_ddp_tpu.solver import make_ilqr_solver as ref_make_solver

    jax.config.update("jax_platforms", "cpu")
    x, u = inputs()
    for core in (("soa",) if soa else ("auto",)):
        prob = ref_kuka_ee(num_time_steps=N, m_blocks=M, num_alpha=A, core=core)
        step = ref_make_step(prob.plant, prob.cfg.integrator, prob.cfg.dt)
        f32 = np.asarray(jax.jit(jax.vmap(step))(x, u))
        f16 = np.asarray(jax.jit(jax.vmap(lambda a, b: step(
            a.astype(jnp.bfloat16), b.astype(jnp.bfloat16)).astype(jnp.float32)))(x, u))
        print(f"JAX step, {prob.plant.name}: bfloat16 against float32 {step_gap(f32, f16):.4f}",
              flush=True)
        if soa:
            continue
        cfg = dataclasses.replace(prob.cfg, max_iter=6, tol_cost=0.0)
        args = (jnp.zeros((N, 14)), jnp.zeros((N, 7)), ref_ee_goal(list(GOAL)))
        o32 = ref_make_solver(prob.plant, prob.cost, cfg)(*args, initial_rollout=True)
        o16 = ref_make_solver(prob.plant, prob.cost, dataclasses.replace(cfg, **BOTH))(
            *args, initial_rollout=True)
        report(f"JAX solve, {prob.plant.name}", o32, o16)
    if not soa:
        prob = ref_kuka_ee()
        cfg = dataclasses.replace(prob.cfg, max_iter=6, tol_cost=0.0)
        x_start = (np.random.default_rng(0).standard_normal(14) * 0.3).astype(np.float32)
        args = (jnp.asarray(np.broadcast_to(x_start, (64, 14)).copy()), jnp.zeros((64, 7)),
                ref_ee_goal([0.0, -0.55, 0.35]))
        o32 = ref_make_solver(prob.plant, prob.cost, cfg)(*args, initial_rollout=True)
        o16 = ref_make_solver(prob.plant, prob.cost, dataclasses.replace(cfg, **BOTH))(
            *args, initial_rollout=True)
        report(f"JAX WAFR cold solve, {prob.plant.name}", o32, o16)
        from parallel_ddp_tpu import constraints as ref_constraints
        from parallel_ddp_tpu.presets import pendulum_swingup as ref_pendulum_swingup

        prob = ref_pendulum_swingup(num_time_steps=64, total_time=2.0, m_blocks=2, num_alpha=8)
        con = ref_constraints.BoxConstraints(n_state=2, n_ctrl=1, u_min=[-6.0], u_max=[6.0])
        for name, flags in AL_VARIANTS:
            cfg = dataclasses.replace(prob.cfg, max_iter=20, tol_cost=0.0, **flags)
            _, info = ref_constraints.solve_al(
                prob.plant, prob.cost, cfg, jnp.zeros((64, 2)), jnp.zeros((64, 1)),
                jnp.asarray([np.pi, 0.0]), con, ref_constraints.ALConfig(max_outer=3))
            print(f"JAX AL pendulum, {name}: violations "
                  f"{[round(v, 5) for v in info['violations']]}", flush=True)


def report(label, o32, o16):
    """A float32 and a bfloat16 solve's alphas, largest J gap and state gap."""
    j32, j16 = (np.asarray(o.J_trace, np.float64) for o in (o32, o16))
    print(f"{label}: alphas float32 {np.asarray(o32.alpha_trace).tolist()} "
          f"bfloat16 {np.asarray(o16.alpha_trace).tolist()}; max J gap "
          f"{np.nanmax(np.abs(j16 - j32) / j32):.4f}; max |x - x_f32| "
          f"{float(np.abs(np.asarray(o16.x) - np.asarray(o32.x)).max()):.4f}", flush=True)


if __name__ == "__main__":
    port()
    if "--jax" in sys.argv[1:]:
        jax_side(soa=False)
    if "--jax-soa" in sys.argv[1:]:
        jax_side(soa=True)
