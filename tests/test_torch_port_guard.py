"""The port stands alone: no module of parallel_ddp_tpu_torch (nor
chip_smoke.py) imports jax or the reference package, and chip_smoke.py
refuses to run without a CUDA GPU.

An `ast` check, not `sys.modules`: a site customisation may import jax at
interpreter start-up."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "parallel_ddp_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "parallel_ddp_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name):
    root = name.split(".")[0]
    return root in FORBIDDEN


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_has_modules():
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    for expected in ("config.py", "solver.py", "presets.py", "interop.py",
                     "models/kuka/soa.py", "ops/cuda_rbd.py",
                     "ops/cuda_rollout.py", "ops/cuda_riccati.py", "ops/build.py",
                     "parallel/backward.py", "parallel/forward.py", "costs/ee.py",
                     "mpc/controls.py", "mpc/driver.py", "mpc/device_loop.py",
                     "mpc/simulator.py"):
        assert expected in names


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_import(path):
    bad = [name for name in _imports(path) if _forbidden(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_guard_detects_forbidden_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import jax.numpy as jnp\nfrom parallel_ddp_tpu.solver import x\n"
                     "import parallel_ddp_tpu_torch\n")
    assert [n for n in _imports(probe) if _forbidden(n)] == [
        "jax.numpy", "parallel_ddp_tpu.solver"]


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_gpu():
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
