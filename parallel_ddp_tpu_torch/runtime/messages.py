"""Wire message schemas — the lcmtypes equivalents (lcmtypes/*.lcm).

The port's own copy of `parallel_ddp_tpu/runtime/messages.py`: the same
classes, fields and bytes on both wires.  `CostParams` carries the port's
`config.CostWeights` (the same 21 fields in the same order).  A
`Trajectory` may hold tensors (a solver state on the card): packing reads
them back to the host in one copy (`to_host`).

Two wire formats per message:
  * native: simple little-endian numpy packing
    [u32 type id][u32 lengths...][payload] — compact, carries everything
    (e.g. Trajectory.dt, Goal.x_target);
  * lcm: the REAL lcmt_* binary layout (runtime/lcm_wire.py) — byte-compatible
    with generated LCM bindings, lcm-spy, Drake and the iiwa driver.

`pack_msg(m, wire)` selects the format; every `unpack` auto-detects (LCM
messages open with a known 8-byte type fingerprint).  Schema mapping:
  Status      <-> drake.lcmt_iiwa_status (q, qd, measured torque, utime)
  Command     <-> drake.lcmt_iiwa_command (torque + reference q)
  CommandHardware <-> drake.lcmt_iiwa_command_hardware (adds wrench[6])
  Trajectory  <-> drake.lcmt_trajectory_f (t0, x, u, KT flattened; dt and the
                  horizon length are consumer configuration on the LCM wire)
  Goal        <-> kuka.lcmt_target_position / lcmt_target_twist
  CostParams  <-> kuka.lcmt_cost_params (the 18 wire weights)
  SolverParams<-> kuka.lcmt_solver_params (iter/time limits, clearVars, costShift)
  ControllerReference <-> kuka.lcmt_robot_controller_reference
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

import torch

from parallel_ddp_tpu_torch.config import CostWeights

_TYPES = {}


def _lw():
    from parallel_ddp_tpu_torch.runtime import lcm_wire

    return lcm_wire


def _registered_lcm(buf: bytes):
    """The LcmStruct whose fingerprint opens buf, or None (native format)."""
    return _lw().is_lcm(buf)


def _register(type_id):
    def deco(cls):
        cls.TYPE_ID = type_id
        _TYPES[type_id] = cls
        return cls

    return deco


def to_host(*arrays):
    """Each of `arrays` as a float32 numpy array of its shape.  The tensors
    among them are read back together: one concatenation on their device and
    ONE copy to the host (a single synchronisation for a solver state on the
    card); numbers and numpy arrays are converted on the host."""
    tensors = [a for a in arrays if isinstance(a, torch.Tensor)]
    flat = None
    if tensors:
        dev = tensors[0].device
        flat = torch.cat([t.detach().to(device=dev, dtype=torch.float32).reshape(-1)
                          for t in tensors]).cpu().numpy()
    out, off = [], 0
    for a in arrays:
        if isinstance(a, torch.Tensor):
            out.append(flat[off:off + a.numel()].reshape(tuple(a.shape)))
            off += a.numel()
        else:
            out.append(np.asarray(a, np.float32))
    return out


def _pack_arrays(type_id: int, scalars: bytes, *arrays: np.ndarray) -> bytes:
    head = struct.pack("<II", type_id, len(scalars)) + scalars
    head += struct.pack("<I", len(arrays))
    out = [head]
    for a in arrays:
        a = np.ascontiguousarray(a, np.float32)
        out.append(struct.pack("<I", a.size))
        out.append(a.tobytes())
    return b"".join(out)


def _unpack_arrays(buf: bytes):
    type_id, slen = struct.unpack_from("<II", buf, 0)
    off = 8
    scalars = buf[off:off + slen]
    off += slen
    (n_arr,) = struct.unpack_from("<I", buf, off)
    off += 4
    arrays = []
    for _ in range(n_arr):
        (sz,) = struct.unpack_from("<I", buf, off)
        off += 4
        arrays.append(np.frombuffer(buf, np.float32, sz, off).copy())
        off += 4 * sz
    return type_id, scalars, arrays


@_register(1)
@dataclass
class Status:
    utime: float
    q: np.ndarray
    qd: np.ndarray
    tau: Optional[np.ndarray] = None

    def pack(self) -> bytes:
        tau = self.tau if self.tau is not None else np.zeros_like(self.q)
        return _pack_arrays(1, struct.pack("<d", self.utime), self.q, self.qd, tau)

    @staticmethod
    def unpack(buf: bytes) -> "Status":
        if _registered_lcm(buf):
            return _lw().status_from_lcm(buf)
        _, s, (q, qd, tau) = _unpack_arrays(buf)
        return Status(struct.unpack("<d", s)[0], q, qd, tau)

    @property
    def x(self) -> np.ndarray:
        return np.concatenate([self.q, self.qd])


@_register(2)
@dataclass
class Command:
    utime: float
    tau: np.ndarray
    q_ref: Optional[np.ndarray] = None

    def pack(self) -> bytes:
        qr = self.q_ref if self.q_ref is not None else np.zeros_like(self.tau)
        return _pack_arrays(2, struct.pack("<d", self.utime), self.tau, qr)

    @staticmethod
    def unpack(buf: bytes) -> "Command":
        if _registered_lcm(buf):
            return _lw().command_from_lcm(buf)
        _, s, (tau, qr) = _unpack_arrays(buf)
        return Command(struct.unpack("<d", s)[0], tau, qr)


@_register(3)
@dataclass
class Trajectory:
    t0: float       # or a 0-d tensor
    dt: float
    x: np.ndarray   # (N, n_state); x, u and K may be tensors
    u: np.ndarray   # (N, n_ctrl)
    K: np.ndarray   # (N, n_ctrl, n_state)

    def on_host(self) -> "Trajectory":
        """This trajectory with numpy fields (tensors read back in one copy)."""
        if not any(isinstance(a, torch.Tensor) for a in (self.t0, self.x, self.u, self.K)):
            return self
        t0, x, u, k = to_host(self.t0, self.x, self.u, self.K)
        return Trajectory(float(t0), self.dt, x, u, k)

    def pack(self) -> bytes:
        t = self.on_host()
        n, nx = t.x.shape
        nu = t.u.shape[1]
        s = struct.pack("<ddIII", t.t0, t.dt, n, nx, nu)
        return _pack_arrays(3, s, t.x.ravel(), t.u.ravel(), t.K.ravel())

    @staticmethod
    def unpack(buf: bytes, nx: Optional[int] = None, nu: Optional[int] = None,
               dt: Optional[float] = None,
               n: Optional[int] = None) -> "Trajectory":
        """nx/nu/dt (and n, for reference-quirk byte-size messages) are
        required to decode the LCM layout, which does not carry them — the
        reference's are compile-time constants.  Native buffers ignore them."""
        if _registered_lcm(buf):
            if nx is None or nu is None or dt is None:
                raise ValueError(
                    "lcmt_trajectory_f needs nx/nu/dt hints to decode"
                )
            return _lw().trajectory_from_lcm(buf, nx, nu, dt, n=n)
        _, s, (x, u, k) = _unpack_arrays(buf)
        t0, dt, n, nx, nu = struct.unpack("<ddIII", s)
        return Trajectory(t0, dt, x.reshape(n, nx), u.reshape(n, nu),
                          k.reshape(n, nu, nx))


@_register(4)
@dataclass
class Goal:
    """Goal update.  Modes:
      0 = EE pose: value (6,) [xyz, rpy]           <- lcmt_target_position use
      1 = joint state: value (n_state,) [q, qd]    <- handleGoalqqd (LCMHelpers.cuh:199)
      2 = EE twist: value (6,) [xyz, vxyz]         <- handleGoalEE / lcmt_target_twist
          (LCMHelpers.cuh:195-197).  NOTE the reference memcpys the twist's
          velocity into the rpy slots of its 6-d eeGoal — with Q_EE2 ~ 1e-6
          the velocity is effectively ignored.  Here mode 2 keeps position and
          velocity separate: position -> ee_goal[:3], velocity -> ee_vel_goal
          (consumed by the EE-velocity cost when USE_EE_VEL_COST weights are on).
    """

    mode: int
    value: np.ndarray
    x_target: Optional[np.ndarray] = None

    MODE_EE_POSE = 0
    MODE_JOINT = 1
    MODE_EE_TWIST = 2

    def pack(self) -> bytes:
        xt = self.x_target if self.x_target is not None else np.zeros(0, np.float32)
        return _pack_arrays(4, struct.pack("<i", self.mode), self.value, xt)

    @staticmethod
    def unpack(buf: bytes) -> "Goal":
        if _registered_lcm(buf):
            return _lw().goal_from_lcm(buf)
        _, s, (v, xt) = _unpack_arrays(buf)
        return Goal(struct.unpack("<i", s)[0], v, xt if xt.size else None)


@_register(5)
@dataclass
class CostParams:
    weights: CostWeights = field(default_factory=CostWeights)

    def pack(self) -> bytes:
        return _pack_arrays(5, b"", np.asarray(list(self.weights), np.float32))

    @staticmethod
    def unpack(buf: bytes) -> "CostParams":
        if _registered_lcm(buf):
            return _lw().cost_params_from_lcm(buf)
        _, _, (w,) = _unpack_arrays(buf)
        return CostParams(CostWeights(*[float(v) for v in w]))


@_register(6)
@dataclass
class SolverParams:
    iter_limit: int = 6
    time_limit_ms: float = 10.0
    clear_vars: bool = False
    cost_shift: int = 0

    def pack(self) -> bytes:
        s = struct.pack("<idii", self.iter_limit, self.time_limit_ms,
                        int(self.clear_vars), self.cost_shift)
        return _pack_arrays(6, s)

    @staticmethod
    def unpack(buf: bytes) -> "SolverParams":
        if _registered_lcm(buf):
            return _lw().solver_params_from_lcm(buf)
        _, s, _ = _unpack_arrays(buf)
        it, tl, cv, cs = struct.unpack("<idii", s)
        return SolverParams(it, tl, bool(cv), cs)


@_register(7)
@dataclass
class CommandHardware:
    """Hardware command with impedance wrench (lcmt_iiwa_command_hardware.lcm:
    joint_position + joint_torque + wrench[6]) — the variant real-arm stacks
    consume; position reference is always populated so the arm works in both
    position- and torque-control modes."""

    utime: float
    q_ref: np.ndarray
    tau: np.ndarray
    wrench: Optional[np.ndarray] = None

    def pack(self) -> bytes:
        w = self.wrench if self.wrench is not None else np.zeros(6, np.float32)
        return _pack_arrays(7, struct.pack("<d", self.utime), self.q_ref,
                            self.tau, w)

    @staticmethod
    def unpack(buf: bytes) -> "CommandHardware":
        if _registered_lcm(buf):
            return _lw().command_hardware_from_lcm(buf)
        _, s, (q, tau, w) = _unpack_arrays(buf)
        return CommandHardware(struct.unpack("<d", s)[0], q, tau, w)


@_register(8)
@dataclass
class ControllerReference:
    """Low-level controller reference (lcmt_robot_controller_reference.lcm:
    desired q/qd/qdd + nominal torque per joint)."""

    utime: float
    q_des: np.ndarray
    qd_des: np.ndarray
    qdd_des: np.ndarray
    u_nominal: np.ndarray

    def pack(self) -> bytes:
        return _pack_arrays(8, struct.pack("<d", self.utime), self.q_des,
                            self.qd_des, self.qdd_des, self.u_nominal)

    @staticmethod
    def unpack(buf: bytes) -> "ControllerReference":
        if _registered_lcm(buf):
            return _lw().controller_reference_from_lcm(buf)
        _, s, (q, qd, qdd, u) = _unpack_arrays(buf)
        return ControllerReference(struct.unpack("<d", s)[0], q, qd, qdd, u)


def pack_msg(m, wire: str = "native") -> bytes:
    """Encode `m` for the chosen wire (PubSub.wire).  LCM encodings are the
    reference's lcmt_* layouts (runtime/lcm_wire.py); the Goal x_target and
    the Trajectory dt do not exist on the LCM wire (consumer configuration,
    exactly as in the reference)."""
    if wire == "native":
        return m.pack()
    if wire != "lcm":
        raise ValueError(f"unknown wire {wire!r}")
    lw = _lw()
    enc = {
        Status: lw.status_to_lcm,
        Command: lw.command_to_lcm,
        CommandHardware: lw.command_hardware_to_lcm,
        Trajectory: lw.trajectory_to_lcm,
        Goal: lw.goal_to_lcm,
        CostParams: lw.cost_params_to_lcm,
        SolverParams: lw.solver_params_to_lcm,
        ControllerReference: lw.controller_reference_to_lcm,
    }[type(m)]
    return enc(m.on_host() if isinstance(m, Trajectory) else m)


def unpack_any(buf: bytes):
    t = _registered_lcm(buf)
    if t is not None:
        lw = _lw()
        dec = {
            "drake.lcmt_iiwa_status": lw.status_from_lcm,
            "drake.lcmt_iiwa_command": lw.command_from_lcm,
            "drake.lcmt_iiwa_command_hardware": lw.command_hardware_from_lcm,
            "kuka.lcmt_target_position": lw.goal_from_lcm,
            "kuka.lcmt_target_twist": lw.goal_from_lcm,
            "kuka.lcmt_cost_params": lw.cost_params_from_lcm,
            "kuka.lcmt_solver_params": lw.solver_params_from_lcm,
            "kuka.lcmt_robot_controller_reference":
                lw.controller_reference_from_lcm,
        }.get(t.full_name)
        if dec is None:
            raise ValueError(
                f"{t.full_name} needs shape hints; use Trajectory.unpack"
            )
        return dec(buf)
    type_id, _, _ = _unpack_arrays(buf)
    return _TYPES[type_id].unpack(buf)
