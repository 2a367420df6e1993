"""LCM wire-format interoperability — real `lcm` bytes on the bus.

The port's own copy of `parallel_ddp_tpu/runtime/lcm_wire.py` (numpy and
`struct` only, byte for byte the same encodings and framing), converting
the port's `runtime/messages.py` dataclasses.

The reference's whole value as a *robotics* runtime is that its bus speaks
LCM: the same topics drive the Drake Kuka simulator and the real iiwa driver
(LCMHelpers.cuh:23-28, lcmtypes/*.lcm, utils/runDrakeSim.sh).  This module
makes the framework a first-class LCM peer without depending on the lcm
package:

  1. a miniature lcm-gen: declarative struct descriptors -> encode/decode with
     the exact generated-binding byte layout (8-byte type fingerprint followed
     by big-endian fields in declaration order);
  2. the reference's ten message types (lcmtypes/lcmt_*.lcm) as descriptors —
     each base hash is REQUIRED (tests/test_lcm_wire.py) to equal the constant
     lcm-gen emitted into the reference's generated headers
     (e.g. lcmtypes/drake/lcmt_iiwa_status.hpp:250), so fingerprints are
     bit-identical to any generated binding's;
  3. converters between runtime/messages.py dataclasses and the lcmt layouts;
  4. the LCM UDP datagram framing (magic LC02 short / LC03 fragmented) used by
     the native bus's wire="lcm" mode (native/ddprt.cpp) and by tests.

Fingerprint algorithm: lcm-gen's struct hash — v = 0x12345678, then per member
update over the name, the primitive type name, and the dimension list, where
update(v, c) = ((v << 8) ^ (v >> 55, arithmetic)) + c and strings contribute
length-then-chars; the registered fingerprint is the 1-bit left-rotation
(none of these types nests another struct, so no recursive composition).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

_M64 = (1 << 64) - 1

# ---------------------------------------------------------------------------
# miniature lcm-gen
# ---------------------------------------------------------------------------

_PRIM = {
    "int64_t": (">q", 8),
    "int32_t": (">i", 4),
    "int16_t": (">h", 2),
    "int8_t": (">b", 1),
    "double": (">d", 8),
    "float": (">f", 4),
    "boolean": (">b", 1),
}
_NP = {"double": ">f8", "float": ">f4", "int64_t": ">i8", "int32_t": ">i4"}


def _upd(v: int, c: int) -> int:
    s = v if v < (1 << 63) else v - (1 << 64)   # arithmetic >> on int64
    return ((((v << 8) & _M64) ^ ((s >> 55) & _M64)) + (c & 0xFF)) & _M64


def _upd_str(v: int, s: str) -> int:
    v = _upd(v, len(s))
    for ch in s:
        v = _upd(v, ord(ch))
    return v


class LcmStruct:
    """One lcm struct: fields are (name, primitive type, dims) with dims a
    sequence of either ints (constant size) or strings (the int32 member
    holding the variable size)."""

    def __init__(self, full_name: str,
                 fields: Sequence[Tuple[str, str, Sequence[Union[int, str]]]]):
        self.full_name = full_name
        self.fields = [(n, t, tuple(d)) for n, t, d in fields]
        self.base_hash = self._compute_base_hash()
        h = self.base_hash
        self.fingerprint = ((h << 1) & _M64) + ((h >> 63) & 1)  # rot-left-1
        self.fingerprint_bytes = struct.pack(">Q", self.fingerprint)

    def _compute_base_hash(self) -> int:
        v = 0x12345678
        for name, typ, dims in self.fields:
            v = _upd_str(v, name)
            v = _upd_str(v, typ)     # all our members are primitives
            v = _upd(v, len(dims))
            for d in dims:
                if isinstance(d, int):
                    v = _upd(v, 0)               # LCM_CONST
                    v = _upd_str(v, str(d))
                else:
                    v = _upd(v, 1)               # LCM_VAR
                    v = _upd_str(v, d)
        return v

    def encode(self, values: Dict) -> bytes:
        out = [self.fingerprint_bytes]
        for name, typ, dims in self.fields:
            val = values[name]
            if not dims:
                fmt, _ = _PRIM[typ]
                out.append(struct.pack(fmt, val))
                continue
            (d,) = dims  # all reference types are 1-D
            n = d if isinstance(d, int) else int(values[d])
            a = np.asarray(val).reshape(-1)
            if a.size != n:
                raise ValueError(
                    f"{self.full_name}.{name}: got {a.size} elements, "
                    f"dimension says {n}"
                )
            out.append(np.ascontiguousarray(a, _NP[typ]).tobytes())
        return b"".join(out)

    def decode(self, buf: bytes) -> Dict:
        if buf[:8] != self.fingerprint_bytes:
            raise ValueError(
                f"fingerprint mismatch for {self.full_name}: "
                f"{buf[:8].hex()} != {self.fingerprint_bytes.hex()}"
            )
        off = 8
        vals: Dict = {}
        for name, typ, dims in self.fields:
            if not dims:
                fmt, sz = _PRIM[typ]
                (vals[name],) = struct.unpack_from(fmt, buf, off)
                off += sz
                continue
            (d,) = dims
            n = d if isinstance(d, int) else int(vals[d])
            dt = np.dtype(_NP[typ])
            vals[name] = np.frombuffer(buf, dt, n, off).astype(dt.newbyteorder("="))
            off += n * dt.itemsize
        return vals


# ---------------------------------------------------------------------------
# the reference's message set (lcmtypes/*.lcm), base hashes asserted against
# the constants in the reference's generated headers in tests/test_lcm_wire.py
# ---------------------------------------------------------------------------

IIWA_STATUS = LcmStruct("drake.lcmt_iiwa_status", [
    ("utime", "int64_t", []),
    ("num_joints", "int32_t", []),
    ("joint_position_measured", "double", ["num_joints"]),
    ("joint_velocity_estimated", "double", ["num_joints"]),
    ("joint_position_commanded", "double", ["num_joints"]),
    ("joint_position_ipo", "double", ["num_joints"]),
    ("joint_torque_measured", "double", ["num_joints"]),
    ("joint_torque_commanded", "double", ["num_joints"]),
    ("joint_torque_external", "double", ["num_joints"]),
])

IIWA_COMMAND = LcmStruct("drake.lcmt_iiwa_command", [
    ("utime", "int64_t", []),
    ("num_joints", "int32_t", []),
    ("joint_position", "double", ["num_joints"]),
    ("num_torques", "int32_t", []),
    ("joint_torque", "double", ["num_torques"]),
])

IIWA_COMMAND_HARDWARE = LcmStruct("drake.lcmt_iiwa_command_hardware", [
    ("utime", "int64_t", []),
    ("num_joints", "int32_t", []),
    ("joint_position", "double", ["num_joints"]),
    ("joint_torque", "double", ["num_joints"]),
    ("wrench", "double", [6]),
])

TRAJECTORY_F = LcmStruct("drake.lcmt_trajectory_f", [
    ("utime", "int64_t", []),
    ("x_size", "int32_t", []),
    ("u_size", "int32_t", []),
    ("KT_size", "int32_t", []),
    ("x", "float", ["x_size"]),
    ("u", "float", ["u_size"]),
    ("KT", "float", ["KT_size"]),
])

TRAJECTORY_D = LcmStruct("drake.lcmt_trajectory_d", [
    ("utime", "int64_t", []),
    ("x_size", "int32_t", []),
    ("u_size", "int32_t", []),
    ("KT_size", "int32_t", []),
    ("x", "double", ["x_size"]),
    ("u", "double", ["u_size"]),
    ("KT", "double", ["KT_size"]),
])

TARGET_POSITION = LcmStruct("kuka.lcmt_target_position", [
    ("utime", "int64_t", []),
    ("position", "float", [7]),
    ("velocity", "float", [7]),
])

TARGET_TWIST = LcmStruct("kuka.lcmt_target_twist", [
    ("utime", "int64_t", []),
    ("position", "float", [3]),
    ("velocity", "float", [3]),
    ("orientation", "float", [4]),
    ("angular_velocity", "float", [3]),
])

COST_PARAMS = LcmStruct("kuka.lcmt_cost_params", [
    ("utime", "int64_t", []),
    ("q_ee1", "float", []), ("q_ee2", "float", []),
    ("qf_ee1", "float", []), ("qf_ee2", "float", []),
    ("q_eev1", "float", []), ("q_eev2", "float", []),
    ("qf_eev1", "float", []), ("qf_eev2", "float", []),
    ("q_xdee", "float", []), ("qf_xdee", "float", []),
    ("q_xee", "float", []), ("qf_xee", "float", []),
    ("r_ee", "float", []),
    ("q1", "float", []), ("q2", "float", []),
    ("qf1", "float", []), ("qf2", "float", []),
    ("r", "float", []),
])

SOLVER_PARAMS = LcmStruct("kuka.lcmt_solver_params", [
    ("utime", "int64_t", []),
    ("iterLimit", "int32_t", []),
    ("timeLimit", "int32_t", []),
    ("clearVars", "int32_t", []),
    ("useCostShift", "int32_t", []),
])

CONTROLLER_REFERENCE = LcmStruct("kuka.lcmt_robot_controller_reference", [
    ("utime", "int64_t", []),
    ("num_joints", "int32_t", []),
    ("joint_position_desired", "double", ["num_joints"]),
    ("joint_velocity_desired", "double", ["num_joints"]),
    ("joint_accel_desired", "double", ["num_joints"]),
    ("u_nominal", "double", ["num_joints"]),
])

ALL_TYPES = [
    IIWA_STATUS, IIWA_COMMAND, IIWA_COMMAND_HARDWARE, TRAJECTORY_F,
    TRAJECTORY_D, TARGET_POSITION, TARGET_TWIST, COST_PARAMS, SOLVER_PARAMS,
    CONTROLLER_REFERENCE,
]
BY_FINGERPRINT = {t.fingerprint_bytes: t for t in ALL_TYPES}


def _usec(t_sec: float) -> int:
    return int(round(t_sec * 1e6))


# ---------------------------------------------------------------------------
# converters: runtime/messages.py dataclasses <-> lcmt layouts
# ---------------------------------------------------------------------------
# imported lazily to avoid a cycle (messages.py imports this module)


def status_to_lcm(s) -> bytes:
    nj = int(np.asarray(s.q).size)
    z = np.zeros(nj)
    tau = s.tau if s.tau is not None else z
    return IIWA_STATUS.encode(dict(
        utime=_usec(s.utime), num_joints=nj,
        joint_position_measured=s.q, joint_velocity_estimated=s.qd,
        joint_position_commanded=z, joint_position_ipo=z,
        joint_torque_measured=tau, joint_torque_commanded=z,
        joint_torque_external=z,
    ))


def status_from_lcm(buf: bytes):
    from parallel_ddp_tpu_torch.runtime.messages import Status

    v = IIWA_STATUS.decode(buf)
    return Status(
        v["utime"] * 1e-6,
        v["joint_position_measured"].astype(np.float32),
        v["joint_velocity_estimated"].astype(np.float32),
        v["joint_torque_measured"].astype(np.float32),
    )


def command_to_lcm(c) -> bytes:
    nj = int(np.asarray(c.tau).size)
    qr = c.q_ref if c.q_ref is not None else np.zeros(nj)
    return IIWA_COMMAND.encode(dict(
        utime=_usec(c.utime), num_joints=nj, joint_position=qr,
        num_torques=nj, joint_torque=c.tau,
    ))


def command_from_lcm(buf: bytes):
    from parallel_ddp_tpu_torch.runtime.messages import Command

    v = IIWA_COMMAND.decode(buf)
    qr = v["joint_position"].astype(np.float32)
    tau = v["joint_torque"].astype(np.float32)
    if tau.size == 0:  # position-mode command (num_torques == 0 is legal)
        tau = np.zeros_like(qr)
    return Command(v["utime"] * 1e-6, tau, qr if qr.size else None)


def command_hardware_to_lcm(c) -> bytes:
    nj = int(np.asarray(c.tau).size)
    w = c.wrench if c.wrench is not None else np.zeros(6)
    return IIWA_COMMAND_HARDWARE.encode(dict(
        utime=_usec(c.utime), num_joints=nj, joint_position=c.q_ref,
        joint_torque=c.tau, wrench=w,
    ))


def command_hardware_from_lcm(buf: bytes):
    from parallel_ddp_tpu_torch.runtime.messages import CommandHardware

    v = IIWA_COMMAND_HARDWARE.decode(buf)
    return CommandHardware(
        v["utime"] * 1e-6, v["joint_position"].astype(np.float32),
        v["joint_torque"].astype(np.float32), v["wrench"].astype(np.float32),
    )


def trajectory_to_lcm(t, byte_sizes: bool = True) -> bytes:
    """Trajectory -> drake.lcmt_trajectory_f.

    Layout follows the reference exactly: utime = t0 in microseconds; KT is
    the per-step TRANSPOSED gain (N, nx, nu) flattened; and — quirk — the
    reference publishes the *_size fields as BYTE counts and zero-pads each
    float array out to that element count (LCMHelpers.cuh:246-262: u_size =
    ld_u*steps*sizeof(float), then u.resize(u_size) with memcpy of u_size
    bytes), so a reference peer memcpy-ing `u_size` BYTES out reads exactly
    the real data.  byte_sizes=False emits tight arrays (sizes = element
    counts) for non-reference LCM peers; the decoder accepts both.  dt is not
    on the wire (the reference bakes it at compile time) — decoders supply it.
    """
    n, nx = t.x.shape
    nu = t.u.shape[1]
    kt = np.ascontiguousarray(np.transpose(t.K, (0, 2, 1)), np.float32)
    pad = 4 if byte_sizes else 1
    vals = dict(utime=_usec(t.t0))
    for name, arr, count in [("x", t.x, n * nx), ("u", t.u, n * nu),
                             ("KT", kt, n * nx * nu)]:
        flat = np.zeros(count * pad, np.float32)
        flat[:count] = np.asarray(arr, np.float32).reshape(-1)
        vals[name] = flat
        vals[f"{name}_size" if name != "KT" else "KT_size"] = count * pad
    return TRAJECTORY_F.encode(vals)


def trajectory_from_lcm(buf: bytes, nx: int, nu: int, dt: float,
                        n: Optional[int] = None):
    """dt/nx/nu come from the consumer's configuration (the reference's are
    compile-time constants, so the wire carries only utime + flat arrays).

    `n` (horizon length) disambiguates the reference's byte-size quirk: a
    quirked message is byte-identical to a tight one with 4x the steps and
    zero tails, so — like the reference, whose TRAJ_RUNNER_TIME_STEPS is a
    compile-time constant — a peer that may receive quirked messages must know
    its horizon.  n=None assumes tight sizes (element counts)."""
    from parallel_ddp_tpu_torch.runtime.messages import Trajectory

    v = TRAJECTORY_F.decode(buf)
    x = v["x"].astype(np.float32)
    u = v["u"].astype(np.float32)
    kt = v["KT"].astype(np.float32)
    if n is None:
        n = u.size // nu
    if x.size < n * nx or u.size < n * nu or kt.size < n * nx * nu:
        raise ValueError(
            f"lcmt_trajectory_f too small for horizon n={n} "
            f"(x {x.size}, u {u.size}, KT {kt.size})"
        )
    x = x[: n * nx].reshape(n, nx)
    u = u[: n * nu].reshape(n, nu)
    kt = kt[: n * nx * nu].reshape(n, nx, nu)
    return Trajectory(v["utime"] * 1e-6, dt, x, u,
                      np.ascontiguousarray(np.transpose(kt, (0, 2, 1))))


def goal_to_lcm(g) -> bytes:
    """Goal -> kuka.lcmt_target_position (joint mode) or kuka.lcmt_target_twist
    (EE modes).  The reference's EE-goal handler copies the twist's velocity
    into its eeGoal[3:6] slots (LCMHelpers.cuh:195-197), so MODE_EE_POSE's rpy
    and MODE_EE_TWIST's velocity ride the same wire slots; decoding always
    yields MODE_EE_TWIST.  x_target does not exist on the LCM wire."""
    from parallel_ddp_tpu_torch.runtime.messages import Goal

    v = np.asarray(g.value, np.float32).reshape(-1)
    if g.mode == Goal.MODE_JOINT:
        q = v[:7]
        qd = v[7:14] if v.size >= 14 else np.zeros(7, np.float32)
        return TARGET_POSITION.encode(dict(utime=0, position=q, velocity=qd))
    vel = v[3:6] if v.size >= 6 else np.zeros(3, np.float32)
    return TARGET_TWIST.encode(dict(
        utime=0, position=v[:3], velocity=vel,
        orientation=np.array([1.0, 0, 0, 0], np.float32),
        angular_velocity=np.zeros(3, np.float32),
    ))


def goal_from_lcm(buf: bytes):
    from parallel_ddp_tpu_torch.runtime.messages import Goal

    fp = buf[:8]
    if fp == TARGET_POSITION.fingerprint_bytes:
        v = TARGET_POSITION.decode(buf)
        val = np.concatenate([v["position"], v["velocity"]]).astype(np.float32)
        return Goal(Goal.MODE_JOINT, val)
    v = TARGET_TWIST.decode(buf)
    val = np.concatenate([v["position"], v["velocity"]]).astype(np.float32)
    return Goal(Goal.MODE_EE_TWIST, val)


def cost_params_to_lcm(cp) -> bytes:
    w = cp.weights
    return COST_PARAMS.encode(dict(
        utime=0,
        q_ee1=w.q_ee1, q_ee2=w.q_ee2, qf_ee1=w.qf_ee1, qf_ee2=w.qf_ee2,
        q_eev1=w.q_eev1, q_eev2=w.q_eev2, qf_eev1=w.qf_eev1, qf_eev2=w.qf_eev2,
        q_xdee=w.q_xdee, qf_xdee=w.qf_xdee, q_xee=w.q_xee, qf_xee=w.qf_xee,
        r_ee=w.r_ee, q1=w.q1, q2=w.q2, qf1=w.qf1, qf2=w.qf2, r=w.r,
    ))


def cost_params_from_lcm(buf: bytes):
    """The 18 wire weights (cost_arm.cuh's Q_EE1..R); the three limit-penalty
    weights are not in lcmt_cost_params and keep their defaults."""
    from parallel_ddp_tpu_torch.config import CostWeights
    from parallel_ddp_tpu_torch.runtime.messages import CostParams

    v = COST_PARAMS.decode(buf)
    return CostParams(CostWeights(
        q1=v["q1"], q2=v["q2"], r=v["r"], qf1=v["qf1"], qf2=v["qf2"],
        q_ee1=v["q_ee1"], q_ee2=v["q_ee2"], qf_ee1=v["qf_ee1"],
        qf_ee2=v["qf_ee2"], q_eev1=v["q_eev1"], q_eev2=v["q_eev2"],
        qf_eev1=v["qf_eev1"], qf_eev2=v["qf_eev2"], r_ee=v["r_ee"],
        q_xdee=v["q_xdee"], qf_xdee=v["qf_xdee"], q_xee=v["q_xee"],
        qf_xee=v["qf_xee"],
    ))


def solver_params_to_lcm(sp) -> bytes:
    return SOLVER_PARAMS.encode(dict(
        utime=0, iterLimit=int(sp.iter_limit),
        timeLimit=int(round(sp.time_limit_ms)),
        clearVars=int(sp.clear_vars), useCostShift=int(sp.cost_shift),
    ))


def solver_params_from_lcm(buf: bytes):
    from parallel_ddp_tpu_torch.runtime.messages import SolverParams

    v = SOLVER_PARAMS.decode(buf)
    return SolverParams(v["iterLimit"], float(v["timeLimit"]),
                        bool(v["clearVars"]), v["useCostShift"])


def controller_reference_to_lcm(cr) -> bytes:
    nj = int(np.asarray(cr.q_des).size)
    return CONTROLLER_REFERENCE.encode(dict(
        utime=_usec(cr.utime), num_joints=nj,
        joint_position_desired=cr.q_des, joint_velocity_desired=cr.qd_des,
        joint_accel_desired=cr.qdd_des, u_nominal=cr.u_nominal,
    ))


def controller_reference_from_lcm(buf: bytes):
    from parallel_ddp_tpu_torch.runtime.messages import ControllerReference

    v = CONTROLLER_REFERENCE.decode(buf)
    return ControllerReference(
        v["utime"] * 1e-6,
        v["joint_position_desired"].astype(np.float32),
        v["joint_velocity_desired"].astype(np.float32),
        v["joint_accel_desired"].astype(np.float32),
        v["u_nominal"].astype(np.float32),
    )


def is_lcm(buf: bytes) -> Optional[LcmStruct]:
    """The type whose fingerprint opens `buf`, or None (native format)."""
    return BY_FINGERPRINT.get(buf[:8]) if len(buf) >= 8 else None


# ---------------------------------------------------------------------------
# LCM UDP datagram framing (udpm): short LC02 / fragmented LC03, big-endian
# ---------------------------------------------------------------------------

MAGIC_SHORT = 0x4C433032  # "LC02"
MAGIC_LONG = 0x4C433033   # "LC03"
MAX_DATAGRAM = 65499      # 65535 - IP(20) - UDP(8) - slack, LCM's limit
_FRAG_HDR = 20            # magic,u32 seq,u32 size,u32 offset,u16 no,u16 count


def frame_short(seq: int, channel: str, payload: bytes) -> bytes:
    return (struct.pack(">II", MAGIC_SHORT, seq & 0xFFFFFFFF)
            + channel.encode() + b"\0" + payload)


def frame_datagrams(seq: int, channel: str, payload: bytes) -> List[bytes]:
    """One short datagram when it fits, else LC03 fragments (channel string
    rides only in fragment 0, per the LCM udpm provider)."""
    ch = channel.encode() + b"\0"
    if 8 + len(ch) + len(payload) <= MAX_DATAGRAM:
        return [frame_short(seq, channel, payload)]
    out = []
    max0 = MAX_DATAGRAM - _FRAG_HDR - len(ch)
    maxn = MAX_DATAGRAM - _FRAG_HDR
    # fragment sizes: fragment 0 is smaller by the channel string
    sizes = [min(max0, len(payload))]
    while sum(sizes) < len(payload):
        sizes.append(min(maxn, len(payload) - sum(sizes)))
    off = 0
    for i, sz in enumerate(sizes):
        hdr = struct.pack(">IIIIHH", MAGIC_LONG, seq & 0xFFFFFFFF,
                          len(payload), off, i, len(sizes))
        body = (ch if i == 0 else b"") + payload[off:off + sz]
        out.append(hdr + body)
        off += sz
    return out


class _Reassembly:
    __slots__ = ("seq", "size", "channel", "buf", "got")

    def __init__(self, seq, size):
        self.seq, self.size = seq, size
        self.channel: Optional[str] = None
        self.buf = bytearray(size)
        self.got = 0


def parse_datagram(pkt: bytes, reasm: Dict) -> Optional[Tuple[str, bytes]]:
    """Feed one datagram; returns (channel, payload) when a message completes.
    `reasm` holds in-flight fragmented messages keyed by sender (callers key
    the dict per source address; LCM does the same)."""
    if len(pkt) < 8:
        return None
    magic, seq = struct.unpack_from(">II", pkt, 0)
    if magic == MAGIC_SHORT:
        z = pkt.index(b"\0", 8)
        return pkt[8:z].decode(), pkt[z + 1:]
    if magic != MAGIC_LONG or len(pkt) < _FRAG_HDR:
        return None
    _, seq, size, off, fno, nfrag = struct.unpack_from(">IIIIHH", pkt, 0)
    r = reasm.get("r")
    if r is None or r.seq != seq or r.size != size:
        r = _Reassembly(seq, size)
        reasm["r"] = r
    body = pkt[_FRAG_HDR:]
    if fno == 0:
        z = body.index(b"\0")
        r.channel = body[:z].decode()
        body = body[z + 1:]
    if off + len(body) <= size:
        r.buf[off:off + len(body)] = body
        r.got += len(body)
    if r.got >= size and r.channel is not None:
        del reasm["r"]
        return r.channel, bytes(r.buf)
    return None
