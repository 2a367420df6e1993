"""ctypes binding to the native UDP-multicast pub/sub bus (native/ddprt.cpp).

The port's twin of `parallel_ddp_tpu/runtime/pubsub.py`: the same channels,
classes and semantics over the same C ABI, so a port node and a JAX-package
node on one group and port talk to each other.  The reference's
communication plane is LCM over UDP multicast with latest-wins subscriptions
(LCMHelpers.cuh); this is the same topology with the same channel
vocabulary.  Default group/port are LCM's defaults, so a multi-machine setup
(solver box <-> robot box) works identically.

The library is built from `native/ddprt.cpp` (at the root of the checkout,
shared by both packages) with `g++` on first use, into
`build/ddprt/<hash of the source and the flags>/`, as `ops/build.py` builds
the kernels: a changed source rebuilds, an unchanged one loads at once.  A
failed build raises with the compiler's output; nothing falls back to a
prebuilt library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "ddprt.cpp"
BUILD_ROOT = _ROOT / "build" / "ddprt"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared")
LIB_NAME = "libddprt.so"


class Channels:
    """Channel names (LCMHelpers.cuh:23-28)."""

    GOAL = "GOAL_CHANNEL"
    TRAJ = "TRAJ_CHANNEL"
    COMMAND = "IIWA_COMMAND"
    STATUS = "IIWA_STATUS"
    STATUS_FILTERED = "IIWA_STATUS_FILTERED"
    COST_PARAMS = "COST_PARAMS_CHANNEL"
    SOLVER_PARAMS = "SOLVER_PARAMS_CHANNEL"


def _digest() -> str:
    if not SOURCE.is_file():
        raise RuntimeError(f"the bus source {SOURCE} is missing")
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the bus library if this source has none yet; its path.  Raises
    RuntimeError with the compiler's output when g++ is missing or fails."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native bus library cannot be built")
    out_dir.mkdir(parents=True, exist_ok=True)
    # compile into a temporary name and rename, so a concurrent build or a
    # killed one never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE), "-lpthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building the bus library failed (exit {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=1)
def lib() -> ctypes.CDLL:
    """The loaded bus library, built on first use."""
    lib = ctypes.CDLL(str(build()))
    lib.ps_create.restype = ctypes.c_void_p
    lib.ps_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
    ]
    lib.ps_destroy.argtypes = [ctypes.c_void_p]
    lib.ps_subscribe.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ps_publish.restype = ctypes.c_int
    lib.ps_publish.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.ps_poll.restype = ctypes.c_int
    lib.ps_poll.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.tr_create.restype = ctypes.c_void_p
    lib.tr_destroy.argtypes = [ctypes.c_void_p]
    lib.tr_set_traj.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_double, ctypes.c_double,
    ]
    lib.tr_get_control.restype = ctypes.c_int
    lib.tr_get_control.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    lib.ps_now.restype = ctypes.c_double
    return lib


class PubSub:
    """Named-channel pub/sub with latest-wins delivery.

    wire="native" publishes the compact native framing; wire="lcm" publishes
    real LCM udpm datagrams (magic LC02/LC03, runtime/lcm_wire.py), making the
    bus a first-class peer of lcm-spy / Drake / the iiwa driver — the
    reference's plane (LCMHelpers.cuh:23-28).  RECEIVING auto-detects both
    framings regardless of this flag, so mixed fleets interoperate.  Default
    group/port are LCM's defaults."""

    def __init__(self, group: str = "239.255.76.67", port: int = 7667,
                 ttl: int = 0, loopback: bool = True, wire: str = "native"):
        if wire not in ("native", "lcm"):
            raise ValueError(f"wire must be 'native' or 'lcm', got {wire!r}")
        self.wire = wire
        self._lib = lib()
        self._h = self._lib.ps_create(group.encode(), port, ttl, int(loopback),
                                      1 if wire == "lcm" else 0)
        if not self._h:
            raise RuntimeError(f"failed to create the multicast pub/sub bus on "
                               f"{group}:{port}")
        self._seen: dict = {}
        self._local = threading.local()

    def close(self):
        if self._h:
            self._lib.ps_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def subscribe(self, channel: str):
        self._lib.ps_subscribe(self._h, channel.encode())

    def publish(self, channel: str, payload: bytes):
        rc = self._lib.ps_publish(self._h, channel.encode(), payload, len(payload))
        if rc != 0:
            raise RuntimeError(f"publish to {channel} failed (payload {len(payload)}B)")

    def _poll(self, channel: str, max_len: int):
        """(length or -1, the buffer holding the message, receive time, seq).
        The buffer is this thread's own and is reused by its next poll: a
        node polls every channel thousands of times a second, and a fresh
        zeroed buffer each time holds the interpreter lock for nothing."""
        buf = getattr(self._local, "buf", None)
        if buf is None or len(buf) < max_len:
            buf = self._local.buf = ctypes.create_string_buffer(max_len)
        t = ctypes.c_double()
        seq = ctypes.c_uint64()
        n = self._lib.ps_poll(self._h, channel.encode(), buf, max_len,
                              ctypes.byref(t), ctypes.byref(seq))
        return n, buf, t.value, seq.value

    def poll(self, channel: str, max_len: int = 65000) -> Optional[Tuple[bytes, float]]:
        """Latest message on channel or None (never blocks)."""
        n, buf, t, _ = self._poll(channel, max_len)
        if n < 0:
            return None
        return buf[:n], t

    def poll_new(self, channel: str, max_len: int = 65000):
        """Latest message only if it is new since the last poll_new call."""
        n, buf, t, seq = self._poll(channel, max_len)
        if n < 0:
            return None
        if self._seen.get(channel) == seq:
            return None
        self._seen[channel] = seq
        return buf[:n], t


class NativeTrajRunner:
    """GIL-free trajectory store + control evaluator (native/ddprt.cpp tr_*)."""

    def __init__(self, n_state: int, n_ctrl: int):
        self._lib = lib()
        self._h = self._lib.tr_create()
        self.n_state = n_state
        self.n_ctrl = n_ctrl

    def __del__(self):
        try:
            if self._h:
                self._lib.tr_destroy(self._h)
        except Exception:
            pass

    def set_traj(self, x: np.ndarray, u: np.ndarray, K: np.ndarray,
                 t0: float, dt: float):
        x = np.ascontiguousarray(x, np.float32)
        u = np.ascontiguousarray(u, np.float32)
        K = np.ascontiguousarray(K, np.float32)
        n = x.shape[0]
        if x.shape != (n, self.n_state) or u.shape != (n, self.n_ctrl) or \
                K.shape != (n, self.n_ctrl, self.n_state):
            raise ValueError(f"trajectory shapes x {x.shape}, u {u.shape}, K {K.shape} do not "
                             f"fit n_state {self.n_state}, n_ctrl {self.n_ctrl}")
        fp = ctypes.POINTER(ctypes.c_float)
        self._lib.tr_set_traj(
            self._h, n, self.n_state, self.n_ctrl,
            x.ctypes.data_as(fp), u.ctypes.data_as(fp), K.ctypes.data_as(fp),
            t0, dt,
        )

    def get_control(self, t: float, x_meas: np.ndarray,
                    use_feedback: bool = True) -> Tuple[np.ndarray, int]:
        """Returns (u, rc): rc 0 ok, 1 past trajectory end, 2 no trajectory."""
        x_meas = np.ascontiguousarray(x_meas, np.float32)
        if x_meas.shape != (self.n_state,):
            raise ValueError(f"x_meas must have shape ({self.n_state},), got {x_meas.shape}")
        u_out = np.zeros(self.n_ctrl, np.float32)
        fp = ctypes.POINTER(ctypes.c_float)
        rc = self._lib.tr_get_control(
            self._h, t, x_meas.ctypes.data_as(fp), u_out.ctypes.data_as(fp),
            int(use_feedback),
        )
        return u_out, rc
