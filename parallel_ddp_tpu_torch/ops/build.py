"""Build and load the CUDA kernels of `csrc/`.

The kernels are CUDA C++ for `sm_90a` with a plain C interface, compiled by
`nvcc` (one process per source, all started together) and linked into one
shared library loaded with `ctypes` (no PyTorch headers, so a build takes
seconds, not minutes).  The library goes into
`build/torch_kernels/<hash of every file under csrc/ and the flags>/` at the
root of the checkout, so a changed source or header rebuilds and an unchanged
tree loads at once.

Nothing here runs at import time: `library()` builds on first use.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("common.cu", "rbd_jac.cu", "rollout.cu", "riccati.cu", "qdd.cu", "sim_chain.cu",
           "graph_nodes.cu")
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libpddp_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # consts, x, u, jac, qdd, ab, batch, dt, stream
    "pddp_rbd_jac": (_P, _P, _P, _P, _P, _P, _I, _F, _P),
    # consts, x_swept, u, K, du, xp, alphas, skip, xout, uout,
    # n_scen, n_alpha, n_blocks, nf, integrator, h, h_half, h_sixth, stream
    "pddp_rollout": (_P,) * 10 + (_I, _I, _I, _I, _I, _F, _F, _F, _P),
    # the same arguments: the step in bfloat16
    "pddp_rollout_bf16": (_P,) * 10 + (_I, _I, _I, _I, _I, _F, _F, _F, _P),
    # seedP, seedp, rho, rho_stride, AB, H, g, d, k, P, p, K, du, ApBK, Bdu,
    # dj_lane, fail_lane, dj_total, fail_total, lanes_done, S, Mb, Nb, n, m, nf,
    # n_blocks_f, state_reg, use_defect, clocks, stream
    "pddp_riccati": (_P,) * 3 + (_I,) + (_P,) * 16 + (_I,) * 9 + (_P, _P),
    # consts, x, u, qdd, batch, stream
    "pddp_qdd": (_P, _P, _P, _P, _I, _P),
    # consts, x0, u, traj_x, traj_u, traj_K, t0, t, xs, t_out, batch, T, n_traj,
    # traj_dt, sim_dt, use_feedback, integrator, h, h_half, h_sixth, stream
    "pddp_sim_chain": (_P,) * 10 + (_I, _I, _I, _F, _F, _I, _I, _F, _F, _F, _P),
    # the same arguments: the Euler chain on the in-step schedule
    "pddp_sim_chain_in_step": (_P,) * 10 + (_I, _I, _I, _F, _F, _I, _I, _F, _F, _F, _P),
    # parent stream, flag, body stream, capture mode, handle out, body graph out
    "pddp_while_begin": (_P, _P, _P, _I, ctypes.POINTER(ctypes.c_ulonglong),
                         ctypes.POINTER(ctypes.c_void_p)),
    # body stream, handle, flag
    "pddp_while_end": (_P, ctypes.c_ulonglong, _P),
    # graph, node count out
    "pddp_graph_nodes": (_P, ctypes.POINTER(ctypes.c_ulonglong)),
}
# the raw handle of a device's current stream without building a Stream object
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def digest_files() -> list[pathlib.Path]:
    """Every file under `csrc/`: what the build's hash covers, so a header a
    source includes cannot change without a rebuild, listed anywhere or not."""
    return sorted(p for p in CSRC.rglob("*") if p.is_file())


def _digest() -> str:
    missing = [s for s in SOURCES if not (CSRC / s).is_file()]
    if missing:
        raise RuntimeError(f"kernel sources missing from {CSRC}: {missing}")
    h = hashlib.sha256()
    for path in digest_files():
        h.update(path.relative_to(CSRC).as_posix().encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels of parallel_ddp_tpu_torch cannot be built")


def build() -> tuple[pathlib.Path, float, str]:
    """Compile the kernels if this source set has no library yet.

    Returns (library path, build seconds (0 when it was already built), the
    compiler's output).  Raises RuntimeError with the compiler output when
    nvcc is missing or fails."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    log = out_dir / "nvcc.log"
    if lib.exists():
        return lib, 0.0, log.read_text() if log.exists() else ""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in SOURCES:
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / src),
               "-o", str(out_dir / (src + ".o"))]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)))
    output, failed = "", []
    for cmd, proc in jobs:
        out, _ = proc.communicate()
        output += out
        if proc.returncode != 0:
            failed.append(f"exit {proc.returncode}: {' '.join(cmd)}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed) + "\n" + output)
    # link into a temporary name and rename, so a concurrent build or a
    # killed one never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc, "-shared", "-o", tmp] + [str(out_dir / (s + ".o")) for s in SOURCES]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc link failed (exit {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    log.write_text(output)
    os.replace(tmp, lib)
    return lib, seconds, output


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.pddp_error_string.argtypes = (ctypes.c_int,)
    lib.pddp_error_string.restype = ctypes.c_char_p
    return lib


def check_input(name, t, shape, dtype=torch.float32) -> None:
    """Raise unless t is a contiguous CUDA tensor of this shape and dtype —
    what a kernel takes."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(name: str, device: torch.device, *args) -> None:
    """Call the library's launch function `name` with `args` and the current
    stream of `device`; raise if the launch was refused.  The device context
    is entered only when `device` is not already the current one."""
    fn = getattr(library(), name)
    index = device.index
    if index is None or index == torch.cuda.current_device():
        status = fn(*args, _current_stream(index))
    else:
        with torch.cuda.device(device):
            status = fn(*args, _current_stream(index))
    check(status, name)


def _current_stream(index) -> int:
    if _RAW_STREAM is not None and index is not None:
        return _RAW_STREAM(index)
    return torch.cuda.current_stream(index).cuda_stream


def check(status: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code (cudaGetLastError)."""
    if status != 0:
        msg = library().pddp_error_string(status).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {status} ({msg})")


class LaunchCounter:
    """How many times one kernel wrapper's kernel ran.

    A launch enqueued eagerly counts on the host.  A launch captured into a
    CUDA graph captures, beside the kernel, an increment of a counter on the
    device, so each replay counts the kernels it ran: a loop body's as many
    times as the loop went round, none for a body the loop skipped.  Reading
    `launches` waits for the device once a graph has counted."""

    def __init__(self, name: str):
        self.name = name
        self._host = 0
        self._device: dict = {}          # torch.device -> 0-d int64 tensor

    def prepare(self, device: torch.device) -> None:
        """Make the device counter (before a capture: none is made during one)."""
        if device not in self._device:
            self._device[device] = torch.zeros((), dtype=torch.int64, device=device)

    def hit(self, device: torch.device) -> None:
        """Count one launch on `device`, enqueued now or captured."""
        if getattr(_uncounted, "on", False):
            return
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            found = self._device.get(device)
            if found is None:
                raise RuntimeError(f"{self.name}: no launch counter on {device} for the "
                                   "capture (build.prepare_counters before capturing)")
            found.add_(1)
        else:
            self._host += 1

    @property
    def launches(self) -> int:
        return self._host + sum(int(c) for c in self._device.values())

    def reset(self) -> None:
        self._host = 0
        for c in self._device.values():
            c.zero_()


COUNTERS: dict = {}                      # name -> LaunchCounter, one per wrapper
_uncounted = threading.local()
_uncounted.on = False


@contextlib.contextmanager
def uncounted():
    """Launch no counting node and count nothing: for graphs that time a
    kernel alone, whose launches are not a path's."""
    prev = getattr(_uncounted, "on", False)
    _uncounted.on = True
    try:
        yield
    finally:
        _uncounted.on = prev


def launch_counter(name: str) -> LaunchCounter:
    COUNTERS[name] = LaunchCounter(name)
    return COUNTERS[name]


def prepare_counters(device: torch.device) -> None:
    for c in COUNTERS.values():
        c.prepare(device)
