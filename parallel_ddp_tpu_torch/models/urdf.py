"""URDF front end: any revolute/prismatic serial-chain robot as a Plant
(twin of `parallel_ddp_tpu/models/urdf.py`).

The reference hardcodes symbolically-generated constants for one robot and
lists "URDF -> constants" as a roadmap item (reference README.md:41, the
iiwa14.urdf it ships is never parsed).  Here the tool exists: parse a URDF
with the stdlib XML parser into the (r_tree, p_tree, I_spatial, ee_offset)
constants consumed by models.kuka.rbd.SerialArmRBD, so any fixed-base
serial arm gets dynamics, derivatives (`torch.func.jacfwd` through the
spatial-algebra core), EE kinematics, and therefore the full iLQR/MPC
stack.  The parsing is numpy and the stdlib, line for line the JAX
package's.

Supported: revolute/continuous AND prismatic joints about/along an arbitrary
axis (the joint frame is re-oriented so the axis becomes local z, the
SerialArmRBD joint model; SCARA/gantry mechanisms load directly), fixed
joints (their transforms are folded into the next joint and their link
inertias are lumped into the preceding modeled link), full inertia tensors
with products and an inertial-frame rpy, and joint position/velocity/effort
limits (returned for use as cost limit penalties, cost_arm.cuh:12-25
analog).  Not supported: branching chains without a `tip` hint,
floating/planar joints, mimic joints.  A URDF arm has no kernel hooks: the
CUDA kernels hold the Kuka's constants only.
"""

from __future__ import annotations

import dataclasses
import os
import xml.etree.ElementTree as ET

import numpy as np

from parallel_ddp_tpu_torch.models.base import Plant
from parallel_ddp_tpu_torch.models.kuka.model import resolve_core
from parallel_ddp_tpu_torch.models.kuka.params import rpy_to_rot, skew
from parallel_ddp_tpu_torch.models.kuka.rbd import SerialArmRBD
from parallel_ddp_tpu_torch.models.kuka.soa import SerialArmSoA


# packaged iiwa-14 model (generated from models/kuka/params.py's numbers; the
# port's own copy); resolved relative to the installed package, not the cwd
IIWA14_URDF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "iiwa14.urdf")


def _floats(s, n, default=None):
    if s is None:
        return np.asarray(default, float)
    out = np.asarray([float(v) for v in s.split()], float)
    assert out.shape == (n,), f"expected {n} floats, got {s!r}"
    return out


def _rot_align_z(axis):
    """Rotation Q with Q @ e3 = axis (minimal rotation; axis must be unit)."""
    a = np.asarray(axis, float)
    a = a / np.linalg.norm(a)
    e3 = np.array([0.0, 0.0, 1.0])
    c = float(e3 @ a)
    if c > 1.0 - 1e-12:
        return np.eye(3)
    if c < -1.0 + 1e-12:
        # axis = -z: rotate pi about x
        return np.diag([1.0, -1.0, -1.0])
    v = np.cross(e3, a)
    vx = skew(v)
    return np.eye(3) + vx + vx @ vx / (1.0 + c)


def _spatial_inertia_full(mass, com, i_com):
    """6x6 spatial inertia at the link frame from a FULL 3x3 COM inertia."""
    ch = skew(np.asarray(com, float))
    out = np.zeros((6, 6))
    out[:3, :3] = i_com - mass * (ch @ ch)
    out[:3, 3:] = mass * ch
    out[3:, :3] = mass * ch.T
    out[3:, 3:] = mass * np.eye(3)
    return out


def _xform_spatial_inertia(i_sp, r, p):
    """Express spatial inertia given in frame B at frame A, where (r, p) is
    B's pose in A (r: B axes in A, p: B origin in A): I_A = X^T I_B X with
    X the A->B motion transform [[r^T, 0], [-r^T skew(p), r^T]]."""
    x = np.zeros((6, 6))
    x[:3, :3] = r.T
    x[3:, :3] = -r.T @ skew(np.asarray(p, float))
    x[3:, 3:] = r.T
    return x.T @ i_sp @ x


@dataclasses.dataclass(frozen=True)
class _Link:
    name: str
    mass: float
    com: np.ndarray       # (3,) in link frame
    i_com: np.ndarray     # (3,3) full inertia about COM, in link frame


@dataclasses.dataclass(frozen=True)
class _Joint:
    name: str
    type: str
    parent: str
    child: str
    rot: np.ndarray       # (3,3) origin rotation (child frame in parent)
    xyz: np.ndarray       # (3,) origin translation
    axis: np.ndarray      # (3,) in the joint (= child link) frame
    limit_lower: float
    limit_upper: float
    limit_velocity: float
    limit_effort: float


@dataclasses.dataclass(frozen=True)
class ArmModel:
    """Parsed serial arm: SerialArmRBD constants + metadata."""

    name: str
    joint_names: tuple
    r_tree: np.ndarray     # (n,3,3)
    p_tree: np.ndarray     # (n,3)
    i_spatial: np.ndarray  # (n,6,6)
    ee_offset: np.ndarray  # (3,) tip position in last modeled link frame
    ee_rot: np.ndarray     # (3,3) tip orientation in last modeled link frame
    # joint limits, (n,) each — feed these to the cost limit penalties
    # (costs/ee.py limit_costs; the reference hardcodes them, cost_arm.cuh:12-25)
    pos_lower: np.ndarray
    pos_upper: np.ndarray
    vel_limit: np.ndarray
    effort_limit: np.ndarray
    joint_types: str = ""   # 'r'/'p' per joint; "" = all revolute

    @property
    def n(self) -> int:
        return len(self.joint_names)

    def rbd(self, gravity: float = 9.81) -> SerialArmRBD:
        """Spatial-algebra core (models/kuka/rbd.py); it computes in the
        dtype of its inputs."""
        return SerialArmRBD(
            self.r_tree, self.p_tree, self.i_spatial, self.ee_offset, gravity,
            ee_rot=self.ee_rot, joint_types=self.joint_types or None,
        )

    def soa(self, gravity: float = 9.81) -> SerialArmSoA:
        """Scalar-channel core (models/kuka/soa.py SerialArmSoA): the same
        math as one elementwise dataflow (the JAX package's TPU core; used
        here for cross-checks)."""
        ee_rot = None if np.allclose(self.ee_rot, np.eye(3)) else self.ee_rot
        return SerialArmSoA.from_tree(
            self.r_tree, self.p_tree, self.i_spatial, self.ee_offset,
            gravity, joint_types=self.joint_types or None, ee_rot=ee_rot,
        )


def _parse(source: str):
    """source: a path or a URDF XML string."""
    if source.lstrip().startswith("<"):
        root = ET.fromstring(source)
    else:
        root = ET.parse(source).getroot()
    assert root.tag == "robot", f"not a URDF (root <{root.tag}>)"

    links = {}
    for le in root.findall("link"):
        name = le.get("name")
        ine = le.find("inertial")
        if ine is None:
            links[name] = _Link(name, 0.0, np.zeros(3), np.zeros((3, 3)))
            continue
        org = ine.find("origin")
        xyz = _floats(org.get("xyz") if org is not None else None, 3, (0, 0, 0))
        rpy = _floats(org.get("rpy") if org is not None else None, 3, (0, 0, 0))
        mass = float(ine.find("mass").get("value"))
        ie = ine.find("inertia")
        g = lambda k: float(ie.get(k, "0"))
        i_f = np.array(
            [
                [g("ixx"), g("ixy"), g("ixz")],
                [g("ixy"), g("iyy"), g("iyz")],
                [g("ixz"), g("iyz"), g("izz")],
            ]
        )
        r_i = rpy_to_rot(rpy)  # inertia given in a frame rotated by rpy
        links[name] = _Link(name, mass, xyz, r_i @ i_f @ r_i.T)

    joints = []
    for je in root.findall("joint"):
        org = je.find("origin")
        xyz = _floats(org.get("xyz") if org is not None else None, 3, (0, 0, 0))
        rpy = _floats(org.get("rpy") if org is not None else None, 3, (0, 0, 0))
        ax = je.find("axis")
        axis = _floats(ax.get("xyz") if ax is not None else None, 3, (0, 0, 1))
        lim = je.find("limit")
        get_l = lambda k, d: float(lim.get(k, d)) if lim is not None else float(d)
        joints.append(
            _Joint(
                je.get("name"), je.get("type"), je.find("parent").get("link"),
                je.find("child").get("link"), rpy_to_rot(rpy), xyz, axis,
                get_l("lower", -np.inf), get_l("upper", np.inf),
                get_l("velocity", np.inf), get_l("effort", np.inf),
            )
        )
    return root.get("name", "urdf_arm"), links, joints


def load_urdf(source: str, tip: str | None = None,
              freeze_branches: bool = False) -> ArmModel:
    """Parse a URDF (path or XML string) into SerialArmRBD constants.

    tip: leaf link terminating the chain (required only if the tree branches).
    Branches OFF the chain are not silently dropped: fixed-mounted subtrees
    (cameras, counterweights, tool hardware) are lumped into the chain link
    that carries them; a branch behind a MOVING joint is an error unless
    freeze_branches=True, which locks such joints at q=0 and lumps the
    subtree too.
    """
    name, links, joints = _parse(source)
    by_child = {j.child: j for j in joints}
    assert len(by_child) == len(joints), "duplicate child link in joints"
    parents = {j.parent for j in joints}
    children = {}
    for j in joints:
        children.setdefault(j.parent, []).append(j)

    if tip is None:
        leaves = [l for l in links if l not in parents and l in by_child]
        assert len(leaves) == 1, (
            f"chain branches (leaves: {sorted(leaves)}); pass tip=..."
        )
        tip = leaves[0]

    # walk tip -> root, then reverse into base-to-tip joint order
    chain = []
    link = tip
    while link in by_child:
        j = by_child[link]
        chain.append(j)
        link = j.parent
    chain.reverse()
    on_chain = {j.name for j in chain}

    r_tree, p_tree, i_sp, jnames, jtypes = [], [], [], [], []
    limits = []
    # pending fixed transform from the last MODELED link frame to the frame
    # the next joint origin lives in
    r_pre, p_pre = np.eye(3), np.zeros(3)

    def lump(link_name, r_lc, p_lc):
        """Add link_name's inertia (pose (r_lc, p_lc) in the current modeled
        frame) onto the last modeled link — fixed-joint mass folding."""
        lk = links[link_name]
        if lk.mass == 0.0 and not lk.i_com.any():
            return
        if not i_sp:
            return  # rigidly attached to the fixed base: no effect on dynamics
        i6 = _spatial_inertia_full(lk.mass, lk.com, lk.i_com)
        i_sp[-1] = i_sp[-1] + _xform_spatial_inertia(i6, r_lc, p_lc)

    def lump_branches(link_name, r_lc, p_lc):
        """Fold every OFF-CHAIN subtree hanging on link_name into the current
        modeled link (pose (r_lc, p_lc) = link_name's frame in that link).
        Dropping them would leave kilograms out of the mass matrix."""
        if not i_sp:
            return  # everything here is still rigid to the fixed base
        for jj in children.get(link_name, []):
            if jj.name in on_chain:
                continue
            if jj.type != "fixed" and not freeze_branches:
                raise ValueError(
                    f"moving joint '{jj.name}' branches off the chain at "
                    f"link '{link_name}'; a serial-arm model cannot carry it."
                    " Pass freeze_branches=True to lock it at q=0, or remove"
                    " the branch from the URDF."
                )
            r_c = r_lc @ jj.rot          # frozen moving joint: Rot(axis,0)=I
            p_c = p_lc + r_lc @ jj.xyz
            lump(jj.child, r_c, p_c)
            lump_branches(jj.child, r_c, p_c)

    for j in chain:
        # compose the joint origin onto the pending fixed transform
        r_j = r_pre @ j.rot
        p_j = p_pre + r_pre @ j.xyz
        if j.type == "fixed":
            lump(j.child, r_j, p_j)
            lump_branches(j.child, r_j, p_j)
            r_pre, p_pre = r_j, p_j
            continue
        assert j.type in ("revolute", "continuous", "prismatic"), (
            f"joint '{j.name}' has unsupported type '{j.type}'"
        )
        # re-orient the child frame so the joint axis is local z: modeled
        # child frame C' = C rotated by Q (Q e3 = axis), so
        # R_origin Rot(axis, q) = (R_origin Q) Rz(q) Q^T — the trailing Q^T
        # becomes the next segment's pending transform.  Prismatic likewise:
        # Trans(axis q) = Q Trans(e3 q) Q^T, so p = p_o + (R_o Q) e3 q
        q_ax = _rot_align_z(j.axis)
        r_tree.append(r_j @ q_ax)
        p_tree.append(p_j)
        jnames.append(j.name)
        jtypes.append("p" if j.type == "prismatic" else "r")
        limits.append((j.limit_lower, j.limit_upper,
                       j.limit_velocity, j.limit_effort))
        # child link inertia, re-expressed in the modeled frame C' (the child
        # frame C's pose in C' is rotation Q^T, zero origin)
        lk = links[j.child]
        i6 = _spatial_inertia_full(lk.mass, lk.com, lk.i_com)
        i_sp.append(_xform_spatial_inertia(i6, q_ax.T, np.zeros(3)))
        r_pre, p_pre = q_ax.T, np.zeros(3)
        lump_branches(j.child, r_pre, p_pre)

    assert jnames, "URDF contains no moving joints on the chain"
    lo, hi, vel, eff = (np.asarray(v, float) for v in zip(*limits))
    return ArmModel(
        name=name, joint_names=tuple(jnames),
        r_tree=np.stack(r_tree), p_tree=np.stack(p_tree),
        i_spatial=np.stack(i_sp),
        ee_offset=p_pre.copy(), ee_rot=r_pre.copy(),
        pos_lower=lo, pos_upper=hi, vel_limit=vel, effort_limit=eff,
        joint_types="".join(jtypes),
    )


def urdf_plant(source: str | ArmModel, tip: str | None = None,
               gravity: float = 9.81, freeze_branches: bool = False,
               core: str = "auto", **plant_kw) -> Plant:
    """Plant for any revolute/prismatic serial arm described by a URDF (or an
    already parsed ArmModel).

    Gives the arm the same surface the built-in Kuka plant has (dynamics, EE
    pose/velocity and the pose Jacobian) so every solver/MPC feature applies
    unchanged.  core: "rbd" spatial-algebra core, "soa" scalar-channel core,
    "auto" = rbd (`models/kuka/model.py resolve_core`); "cuda" raises, as
    the JAX package raises on "pallas": the kernels are Kuka-only.
    """
    arm = (source if isinstance(source, ArmModel)
           else load_urdf(source, tip=tip, freeze_branches=freeze_branches))
    core = resolve_core(core)  # raises on typos; 'cuda' is Kuka-only
    impl = arm.soa(gravity=gravity) if core == "soa" else arm.rbd(gravity=gravity)
    n = arm.n
    return Plant(
        name=f"urdf_{arm.name}_{n}dof_g{gravity:g}_{core}",
        n_pos=n,
        n_ctrl=n,
        dynamics=impl.forward_dynamics,
        ee_pos=impl.ee_pose,
        ee_vel=impl.ee_velocity,
        ee_jac=impl.ee_pose_jacobian,
        **plant_kw,
    )
