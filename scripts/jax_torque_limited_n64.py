#!/usr/bin/env python3
"""The JAX package's torque-limited Kuka EE solve at the WAFR width, on the
CPU, from the goal moved by k float32 ulps: the reference reading that
`chip_smoke.py`'s constraints phase holds the port's card to.

    python3 scripts/jax_torque_limited_n64.py [--k-max 10] [--workers 5]

The solve is tests/test_constraints.py::test_kuka_torque_limited_ee_solve
(|u_i| <= 40 Nm, ALConfig(max_outer=6), max_iter 40, from zeros toward
(0.3, -0.3, 0.9)) at the preset's N = 64 in place of N = 16, on the JAX
package's CPU core (`rbd`).  Its last violation is not a stable number at
this width: the outer loop's path parts at near ties, so the goal is moved
by k = -k_max..k_max ulps (every coordinate, np.nextafter) and each solve
is a sample of the rounding spread.  One process per solve (spawn), each
with two XLA threads; a solve takes 3 to 8 minutes of CPU.

Prints one JSON line per solve (k, the violations, base_J, max|u|, the EE
error) and a last JSON line with the quartiles of the last violation, of
max|u| and of the EE error over all k.
"""

import argparse
import json
import multiprocessing
import os

GOAL = [0.3, -0.3, 0.9]


def solve(k: int) -> dict:
    os.environ["XLA_FLAGS"] = "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=2"
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    from parallel_ddp_tpu.constraints import ALConfig, BoxConstraints, solve_al
    from parallel_ddp_tpu.presets import ee_goal, kuka_ee

    prob = kuka_ee()
    cfg = dataclasses.replace(prob.cfg, max_iter=40)
    g = np.asarray(GOAL, np.float32)
    for _ in range(abs(k)):
        g = np.nextafter(g, np.float32(np.inf if k > 0 else -np.inf))
    con = BoxConstraints(n_state=14, n_ctrl=7, u_min=[-40.0] * 7, u_max=[40.0] * 7)
    out, info = solve_al(prob.plant, prob.cost, cfg, jnp.zeros((64, 14)), jnp.zeros((64, 7)),
                         ee_goal(g.tolist()), con, ALConfig(max_outer=6))
    ee = np.asarray(prob.plant.ee_pos(out.x[-1][:7])[:3])
    return {"k": k, "plant": prob.plant.name, "violations": info["violations"],
            "base_J": info["base_J"], "max_abs_u": float(jnp.abs(out.u).max()),
            "ee_err": float(np.linalg.norm(ee - np.asarray(GOAL)))}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k-max", type=int, default=10)
    ap.add_argument("--workers", type=int, default=5)
    args = ap.parse_args()
    ks = sorted(range(-args.k_max, args.k_max + 1), key=abs)
    with multiprocessing.get_context("spawn").Pool(args.workers) as pool:
        rows = []
        for row in pool.imap_unordered(solve, ks):
            rows.append(row)
            print(json.dumps(row), flush=True)
    import numpy as np

    q = lambda key: [float(v) for v in np.quantile([key(r) for r in rows], [0.0, 0.25, 0.5,
                                                                              0.75, 1.0])]
    print(json.dumps({"solves": len(rows), "quartiles (min, q1, median, q3, max)": {
        "last_violation": q(lambda r: r["violations"][-1]), "max_abs_u": q(lambda r: r["max_abs_u"]),
        "ee_err": q(lambda r: r["ee_err"])}}), flush=True)


if __name__ == "__main__":
    main()
