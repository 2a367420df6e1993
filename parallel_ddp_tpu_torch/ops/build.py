"""Build and load the CUDA kernels of `csrc/`.

The kernels are CUDA C++ for `sm_90a` with a plain C interface, compiled by
`nvcc` into one shared library and loaded with `ctypes` (no PyTorch headers,
so a build takes seconds, not minutes).  The library goes into
`build/torch_kernels/<hash of the sources and flags>/` at the root of the
checkout, so a changed source rebuilds and an unchanged one loads at once.

Nothing here runs at import time: `library()` builds on first use.
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
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("rbd_jac.cu", "rollout.cu", "riccati.cu")
HEADERS = ("kuka_soa.cuh",)
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libpddp_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # consts, x, u, jac, qdd, batch, stream
    "pddp_rbd_jac": (_P, _P, _P, _P, _P, _I, _P),
    # consts, x_swept, u, K, du, xp, alphas, skip, xout, uout,
    # n_alpha, n_blocks, nf, integrator, h, h_half, h_sixth, stream
    "pddp_rollout": (_P,) * 10 + (_I, _I, _I, _I, _F, _F, _F, _P),
    # seedP, seedp, rho, AB, H, g, d, k, P, p, K, du, ApBK, Bdu, dj, fail,
    # Mb, Nb, n, m, nf, n_blocks_f, state_reg, use_defect, stream
    "pddp_riccati": (_P,) * 16 + (_I,) * 8 + (_P,),
}


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
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
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC)]
    cmd += [str(CSRC / s) for s in SOURCES]
    # build into a temporary name and rename, so a concurrent build or a
    # killed one never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd + ["-o", tmp], capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    output = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n{output}")
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


def check(status: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code (cudaGetLastError)."""
    if status != 0:
        msg = library().pddp_error_string(status).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {status} ({msg})")
