"""Carry the JAX reference package's parameters and state into this package.

Each function takes an object of `parallel_ddp_tpu` and returns this
package's counterpart, passing every value through `np.asarray`, so this
module never imports jax: it works on whatever the caller hands it.  The
parity tests use it so that both packages compute on identical inputs.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from parallel_ddp_tpu_torch.config import CostWeights, SolveOutput, SolverConfig
from parallel_ddp_tpu_torch.constraints import BoxConstraints
from parallel_ddp_tpu_torch.models import Plant, cartpole, pendulum, quadrotor
from parallel_ddp_tpu_torch.models.kuka import soa
from parallel_ddp_tpu_torch.models.kuka.model import KukaParams, kuka
from parallel_ddp_tpu_torch.models.urdf import ArmModel
from parallel_ddp_tpu_torch.mpc.driver import MPCState


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


def goal(g, device=None):
    """The reference's goal, one scenario's or a batch's (a leading B on
    every leaf): a goal dict ({"ee_goal", "x_target", ...}, or the AL goal
    {"base": <goal>, "lam", "mu"}, dicts nested to any depth) as dicts of
    tensors; a bare array (the joint costs' target state, (n_state,)), a
    batch of them ((B, n_state), or a sequence of B arrays) as one tensor.
    Dtypes are kept (the reference's arrays are float32)."""
    if isinstance(g, dict):
        return {k: goal(v, device=device) for k, v in g.items()}
    return tensor(g, device=device)


def box_constraints(con) -> BoxConstraints:
    """The reference's `BoxConstraints` (numpy bounds, None where a side is
    unbounded)."""
    return BoxConstraints(con.n_state, con.n_ctrl, con.u_min, con.u_max, con.x_min, con.x_max)


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


def _core(core: str) -> str:
    """The reference's Kuka core as this package's: "pallas" maps to "cuda"
    (the kernel hooks), every other core to "soa"."""
    return "cuda" if core == "pallas" else "soa"


def kuka_params(params) -> KukaParams:
    """The reference's `KukaParams` (its core mapped by `_core`)."""
    return KukaParams(ee_type=params.ee_type, gravity=float(params.gravity),
                      core=_core(params.core))


_ANALYTIC = {"pendulum": pendulum, "cartpole": cartpole, "quadrotor": quadrotor}


def plant(p) -> Plant:
    """The reference's `Plant` as this package's, by its name: the analytic
    plants ("pendulum", "cartpole", "quadrotor") by name alone, the Kuka arm
    ("kuka_ee{ee_type}_g{gravity}_{core}") through the same parameters and
    core mapping as `kuka_params`."""
    if p.name in _ANALYTIC:
        return _ANALYTIC[p.name]()
    if p.name.startswith("urdf_"):
        raise ValueError(
            f"the reference plant {p.name!r} is a URDF arm: its name does not carry the "
            "arm's constants; carry the parsed arm with `arm_model(arm)` and build the "
            "plant with `models.urdf_plant`")
    m = re.fullmatch(r"kuka_ee(\d+)_g([^_]+)_(\w+)", p.name)
    if m is None:
        raise ValueError(f"no counterpart of the reference plant {p.name!r}")
    return kuka(KukaParams(ee_type=int(m.group(1)), gravity=float(m.group(2)),
                           core=_core(m.group(3))))


def arm_model(arm) -> ArmModel:
    """The reference's parsed URDF arm (`models.urdf.ArmModel`, numpy fields):
    the arm's constants are its model parameters."""
    arrays = ("r_tree", "p_tree", "i_spatial", "ee_offset", "ee_rot", "pos_lower", "pos_upper",
              "vel_limit", "effort_limit")
    return ArmModel(name=arm.name, joint_names=tuple(arm.joint_names),
                    joint_types=arm.joint_types,
                    **{f: np.array(np.asarray(getattr(arm, f))) for f in arrays})


def kuka_constants(cc) -> soa._Consts:
    """The reference's scalar-channel chain constants (`soa._Consts`)."""
    return soa._Consts(
        np.asarray(cc.r_tree), np.asarray(cc.p_tree), np.asarray(cc.i_spatial),
        np.asarray(cc.ee_offset), float(cc.gravity),
        joint_types=cc.joint_types,
        ee_rot=None if cc.ee_rot is None else np.asarray(cc.ee_rot),
    )


def mpc_state(st, device=None) -> MPCState:
    """The reference's `MPCState` (x, u, K, P, p, d, t0, fails), so that both
    packages can start a closed loop from the same state: one controller's
    (0-d t0 and fails) or a fleet's (every field with a leading B)."""
    return MPCState(
        x=tensor(st.x, device), u=tensor(st.u, device), K=tensor(st.K, device),
        P=tensor(st.P, device), p=tensor(st.p, device), d=tensor(st.d, device),
        t0=tensor(st.t0, device, torch.float32),
        fails=tensor(st.fails, device, torch.int32),
    )


def solve_output(out, device=None) -> SolveOutput:
    """The reference's `SolveOutput` (one solve's, or a batch's with a
    leading B on every leaf) as this package's."""
    return SolveOutput(*(None if v is None else tensor(v, device) for v in out))
