"""The port's CPU path against the archived convergence goldens of the
canonical WAFR Kuka solve (benchmarks/artifacts/convergence_golden.json,
written by scripts/gen_convergence_golden.py with the reference package).

The port runs its main-path configuration (RBD-Jacobian, rollout and fused
Riccati ops, here their plain versions) on the scalar-channel core; the
golden was taken on the reference's spatial-algebra core.  The two differ in
float32 rounding only, and over 48-80 iterations that rounding moves the
path a little.  Measured on this port:
  * m1_seed0: iteration count and every accepted alpha equal the golden's;
    converged J within 1e-6; mid-descent J up to 0.9% apart (iteration 12),
    back to 1e-6 at convergence;
  * m4_seed0: the first 63 accepted alphas equal the golden's, then the
    paths part (70 iterations against 73); J within 0.3% on the common
    prefix and 0.1% at the end;
  * m1_seed1, m1_seed2: every iteration and alpha equal; J trace within
    5.7e-4, converged J within 2e-7;
  * m4_seed1: all 80 alphas equal; J trace within 3.4e-4, final J 3.2e-4;
  * m4_seed2: the first 37 alphas equal, then the paths part (both run
    the 80 iterations); J within 0.75% on the common prefix, 0.02% at the
    end.
So the rules of tests/test_convergence_golden.py (exact traces, J trace
within 1e-3) are held on the agreeing prefix, and J to the bounds above.
Slow tier: 48-80-iteration N=64 solves on the CPU."""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from parallel_ddp_tpu_torch.presets import ee_goal, kuka_ee
from parallel_ddp_tpu_torch.solver import make_ilqr_solver

GOLDEN = (pathlib.Path(__file__).resolve().parents[1] / "benchmarks" / "artifacts"
          / "convergence_golden.json")


def run_case(m_blocks: int, seed: int, max_iter: int):
    """scripts/gen_convergence_golden.py::run_case on the port."""
    prob = kuka_ee(m_blocks=m_blocks)
    cfg = dataclasses.replace(prob.cfg, max_iter=max_iter, pallas_riccati=True)
    solver = make_ilqr_solver(prob.plant, prob.cost, cfg)
    n = cfg.num_time_steps
    rng = np.random.default_rng(seed)
    x_start = (rng.standard_normal(14) * 0.3).astype(np.float32)
    x0 = torch.as_tensor(np.broadcast_to(x_start, (n, 14)).copy())
    out = solver(x0, torch.zeros(n, 7), ee_goal([0.3, -0.5, 0.4], device="cpu"),
                 initial_rollout=True)
    iters = int(out.iters)
    return {
        "iters": iters,
        "J_final": float(out.J),
        "J_trace": out.J_trace.numpy()[: iters + 1].astype(np.float64),
        "alpha_trace": [int(v) for v in out.alpha_trace.numpy()[:iters]],
    }


# case -> (accepted alphas that must agree (None: all, and the iteration
# count), J_final rtol, J trace rtol over the agreeing prefix)
CASES = {
    "kuka_ee_n64_m1_seed0": (None, 1e-4, 1e-2),
    "kuka_ee_n64_m1_seed1": (None, 1e-4, 1e-3),
    "kuka_ee_n64_m1_seed2": (None, 1e-4, 1e-3),
    "kuka_ee_n64_m4_seed0": (63, 2e-3, 5e-3),
    "kuka_ee_n64_m4_seed1": (None, 1e-3, 1e-3),
    "kuka_ee_n64_m4_seed2": (37, 1e-3, 1e-2),
}


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(CASES))
def test_golden_case_reproduces(name):
    golden = json.loads(GOLDEN.read_text())
    g = golden["cases"][name]
    agree, j_final_rtol, j_trace_rtol = CASES[name]
    r = run_case(g["m_blocks"], g["seed"], golden["max_iter"])
    if agree is None:
        assert r["iters"] == g["iters"], (name, r["iters"], g["iters"])
        agree = g["iters"]
    assert r["alpha_trace"][:agree] == g["alpha_trace"][:agree], name
    np.testing.assert_allclose(r["J_final"], g["J_final"], rtol=j_final_rtol, err_msg=name)
    np.testing.assert_allclose(r["J_trace"][: agree + 1],
                               np.asarray(g["J_trace"])[: agree + 1],
                               rtol=j_trace_rtol, err_msg=name)
