"""The port stands alone: no module of parallel_ddp_tpu_torch (nor
chip_smoke.py) imports jax or the reference package, and chip_smoke.py
refuses to run without a CUDA GPU.

An `ast` check, not `sys.modules`: a site customisation may import jax at
interpreter start-up."""

import ast
import io
import os
import pathlib
import re
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
                     "mpc/simulator.py", "ops/cuda_sim_chain.py", "device.py", "graphs.py",
                     "models/pendulum.py", "models/cartpole.py", "models/quadrotor.py",
                     "costs/joint.py", "constraints.py", "models/kuka/rbd.py",
                     "models/urdf.py", "runtime/messages.py", "runtime/lcm_wire.py",
                     "runtime/pubsub.py", "runtime/nodes.py", "tasks/pick_and_place.py",
                     "utils/checkpoint.py", "utils/profiling.py", "parallel/sharding.py",
                     "parallel/sp.py"):
        assert expected in names


def test_port_has_the_scan_module():
    """The associative scan that the exact backward pass runs on (and the
    log-depth forward sweep is to reuse) is the port's own module."""
    scan = PORT / "parallel" / "scan.py"
    assert scan.is_file()
    tree = ast.parse(scan.read_text())
    assert "associative_scan" in {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}


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


# a path into the reference package's tree: its name as a path component
# ("parallel_ddp_tpu/...", or "parallel_ddp_tpu" alone as os.path.join takes
# it); a file:line citation of its sources ("parallel_ddp_tpu/ops/x.py:12",
# what chip_smoke.py's kernel line names as `replaces`) is no path that is read
_REF_PATH = re.compile(r"(?<![\w.])parallel_ddp_tpu(?:[/\\]|$)")
_CITATION = re.compile(r"parallel_ddp_tpu/[\w/]+\.py:\d+")


def _code_strings(path):
    """The string constants of a file that are not docstrings."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                docs.add(id(body[0].value))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docs:
            yield node.value


def _reference_paths(path):
    return [s for s in _code_strings(path)
            if _REF_PATH.search(s) and not _CITATION.fullmatch(s)]


def test_port_has_the_scan_module():
    """The associative scan that the exact backward pass runs on (and the
    log-depth forward sweep is to reuse) is the port's own module."""
    scan = PORT / "parallel" / "scan.py"
    assert scan.is_file()
    tree = ast.parse(scan.read_text())
    assert "associative_scan" in {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_path_into_the_reference_tree(path):
    """The port reads no file of the reference package: no string of its code
    names a path into `parallel_ddp_tpu/` (the figure-8 data is the port's
    own copy)."""
    bad = _reference_paths(path)
    assert not bad, f"{path.relative_to(ROOT)} names paths into the reference: {bad}"


def test_guard_detects_reference_paths(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text(
        '"""Twin of `parallel_ddp_tpu/presets.py`."""\n'
        'import os\n'
        'A = os.path.join(os.path.dirname(__file__), "parallel_ddp_tpu", "tasks", "g.npz")\n'
        'B = "../parallel_ddp_tpu/tasks/fig8_goals.npz"\n'
        'C = dict(replaces="parallel_ddp_tpu/ops/pallas_rbd.py:48")\n'
        'D = "parallel_ddp_tpu_torch/csrc/qdd.cu"\n')
    assert sorted(_reference_paths(probe)) == ["../parallel_ddp_tpu/tasks/fig8_goals.npz",
                                               "parallel_ddp_tpu"]


def test_fig8_data_is_the_ports_own_copy():
    """The figure-8 task path ships inside the port (package data), byte for
    byte the reference's."""
    from parallel_ddp_tpu_torch import presets

    own = pathlib.Path(presets.FIG8_GOALS)
    assert own.resolve().is_relative_to(PORT.resolve())
    assert own.read_bytes() == (ROOT / "parallel_ddp_tpu" / "tasks" / "fig8_goals.npz").read_bytes()
    assert '"data/*.npz"' in (ROOT / "pyproject.toml").read_text()


def test_iiwa_urdf_is_the_ports_own_copy():
    """The packaged iiwa-14 URDF resolves inside the port (package data),
    byte for byte the reference's."""
    from parallel_ddp_tpu_torch.models import urdf

    own = pathlib.Path(urdf.IIWA14_URDF)
    assert own.resolve().is_relative_to(PORT.resolve())
    assert own.read_bytes() == (ROOT / "parallel_ddp_tpu" / "models" / "data"
                                / "iiwa14.urdf").read_bytes()
    text = (ROOT / "pyproject.toml").read_text()
    assert '"parallel_ddp_tpu_torch.models" = ["data/*.urdf"]' in text


def test_pyproject_lists_every_port_package():
    """Every directory of the port that holds an `__init__.py` is a package
    that pyproject.toml installs."""
    text = (ROOT / "pyproject.toml").read_text()
    for init in PORT.rglob("__init__.py"):
        name = ".".join(init.parent.relative_to(ROOT).parts)
        assert f'"{name}"' in text, name


def _entry_points():
    """Calls that make tensors from non-tensor input and are given no device."""
    import dataclasses

    import numpy as np

    from parallel_ddp_tpu_torch.constraints import (ALConfig, ALMPCController, BoxConstraints,
                                                    solve_al)
    from parallel_ddp_tpu_torch.mpc.driver import MPCConfig, MPCController
    from parallel_ddp_tpu_torch.mpc.simulator import PlantSimulator
    from parallel_ddp_tpu_torch.presets import ee_goal, kuka_ee
    from parallel_ddp_tpu_torch.runtime import messages, nodes
    from parallel_ddp_tpu_torch.solver import make_ilqr_solver
    from parallel_ddp_tpu_torch.utils import checkpoint

    prob = kuka_ee(num_time_steps=16, m_blocks=2, num_alpha=4)
    cfg = dataclasses.replace(prob.cfg, pallas_riccati=True, max_iter=1)
    ctrl = MPCController(prob.plant, prob.cost, cfg, MPCConfig(max_iters_per_solve=1))
    solver = make_ilqr_solver(prob.plant, prob.cost, cfg)
    con = BoxConstraints(n_state=14, n_ctrl=7, u_min=[-40.0] * 7, u_max=[40.0] * 7)
    al_ctrl = ALMPCController(prob.plant, prob.cost, cfg, MPCConfig(max_iters_per_solve=1), con)
    x = np.zeros(14, np.float32)
    goal_kw = dict(xyz=[0.3, -0.3, 0.9])

    def ckpt():
        """A checkpoint file's bytes (np.load takes a file object)."""
        f = io.BytesIO()
        np.savez(f, **{k: np.zeros((2, 3), np.float32) for k in ("x", "u", "K", "P", "p", "d")},
                 t0=np.float32(0.0), fails=np.int32(0))
        f.seek(0)
        return f

    class Bus:
        def subscribe(self, channel):
            pass

    goal_msg = messages.Goal(0, np.zeros(6, np.float32))
    return {
        "ee_goal": lambda **kw: ee_goal(**goal_kw, **kw)["ee_goal"],
        "init_state": lambda **kw: ctrl.init_state(
            x, goal=ee_goal(**goal_kw, **kw), warmup_iters=1, **kw).x,
        "solver": lambda **kw: solver(
            np.zeros((16, 14), np.float32), np.zeros((16, 7), np.float32),
            ee_goal(**goal_kw, **kw), initial_rollout=True, **kw).x,
        "plant_simulator": lambda **kw: PlantSimulator(prob.plant, **kw).device,
        "solve_al": lambda **kw: solve_al(
            prob.plant, prob.cost, cfg, np.zeros((16, 14), np.float32),
            np.zeros((16, 7), np.float32), ee_goal(**goal_kw, **kw), con,
            ALConfig(max_outer=1), **kw)[0].x,
        "al_init_state": lambda **kw: al_ctrl.init_state(
            x, goal=ee_goal(**goal_kw, **kw), warmup_iters=1, **kw)[0].x,
        "al_zero_lam": lambda **kw: al_ctrl.zero_lam(**kw),
        "load_mpc_state": lambda **kw: checkpoint.load_mpc_state(ckpt(), **kw).x,
        "load_warm_start": lambda **kw: checkpoint.load_warm_start(ckpt(), **kw)["x"],
        "mpc_loop_node": lambda **kw: nodes.MPCLoopNode(
            ctrl, Bus(), nodes.ee_goal_to_pytree, goal_msg, **kw)._goal_pytree()["ee_goal"],
        "simulator_node": lambda **kw: nodes.SimulatorNode(prob.plant, Bus(), x, **kw).sim.device,
    }


@pytest.mark.parametrize("name", ["ee_goal", "init_state", "solver", "plant_simulator",
                                  "solve_al", "al_init_state", "al_zero_lam", "load_mpc_state",
                                  "load_warm_start", "mpc_loop_node", "simulator_node"])
def test_entry_points_default_to_the_card(name):
    """Given lists or numpy arrays and no `device`, an entry point builds on
    the card, or raises where there is none: it never falls back to the CPU.
    `device="cpu"` asks for the CPU."""
    import torch

    call = _entry_points()[name]
    if torch.cuda.is_available():
        out = call()
        assert (out if isinstance(out, torch.device) else out.device).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    out = call(device="cpu")
    assert (out if isinstance(out, torch.device) else out.device).type == "cpu"


def test_cpu_tensors_stay_on_the_cpu():
    """A tensor the caller passes keeps its device: that is the caller asking."""
    import dataclasses

    import torch

    from parallel_ddp_tpu_torch.device import as_tensor
    from parallel_ddp_tpu_torch.mpc.driver import MPCConfig, MPCController
    from parallel_ddp_tpu_torch.presets import ee_goal, kuka_ee

    assert as_tensor(torch.zeros(3)).device.type == "cpu"
    assert as_tensor(torch.zeros(3), dtype=torch.float64).dtype == torch.float64
    prob = kuka_ee(num_time_steps=16, m_blocks=2, num_alpha=4)
    cfg = dataclasses.replace(prob.cfg, pallas_riccati=True)
    ctrl = MPCController(prob.plant, prob.cost, cfg, MPCConfig(max_iters_per_solve=1))
    goal = ee_goal([0.3, -0.3, 0.9], device="cpu")
    st = ctrl.init_state(torch.zeros(14), goal=goal, warmup_iters=1)
    assert all(a.device.type == "cpu" for a in st)
    st2, info = ctrl.step(st, [0.0] * 14, 0.01, goal)       # a list follows the state
    assert all(a.device.type == "cpu" for a in st2) and info.J.device.type == "cpu"


CSRC = PORT / "csrc"


def _csrc_files():
    return sorted(p for p in CSRC.rglob("*") if p.suffix in (".cu", ".cuh"))


@pytest.mark.parametrize("path", _csrc_files(), ids=lambda p: p.name)
def test_includes_are_covered_by_the_build_digest(path):
    """Every `#include "..."` of a kernel source names a file the build's hash
    covers, so no header can change and leave a stale library behind."""
    from parallel_ddp_tpu_torch.ops import build

    covered = {p.resolve() for p in build.digest_files()}
    assert path.resolve() in covered
    for name in re.findall(r'^\s*#include\s+"([^"]+)"', path.read_text(), flags=re.M):
        assert (path.parent / name).resolve() in covered, f"{path.name} includes {name}"


def test_build_digest_follows_every_file(tmp_path, monkeypatch):
    """The hash changes with a header no list names, and a listed source that
    is missing is an error."""
    from parallel_ddp_tpu_torch.ops import build

    copy = tmp_path / "csrc"
    shutil.copytree(CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    base = build._digest()
    assert base == build._digest()
    (copy / "some_new_header.cuh").write_text("#pragma once\n")
    with_header = build._digest()
    assert with_header != base
    (copy / "some_new_header.cuh").write_text("#pragma once\n#define X 1\n")
    assert build._digest() not in (base, with_header)
    (copy / build.SOURCES[0]).unlink()
    with pytest.raises(RuntimeError, match="missing"):
        build._digest()


def _launch_functions():
    """(name, argument count) of every `extern "C" int pddp_*(...)` in csrc/."""
    found = {}
    for path in _csrc_files():
        for name, args in re.findall(r'extern\s+"C"\s+int\s+(pddp_\w+)\s*\(([^)]*)\)\s*\{',
                                     path.read_text()):
            found[name] = len([a for a in args.split(",") if a.strip()])
    return found


def test_every_launch_function_has_its_signature():
    """Each launch function of the sources is bound with as many ctypes
    arguments as it takes, each signature names a function that exists, and
    the error-string function has a source."""
    from parallel_ddp_tpu_torch.ops import build

    found = _launch_functions()
    assert set(found) == set(build._SIGNATURES)
    for name, count in found.items():
        assert len(build._SIGNATURES[name]) == count, name
    assert any("pddp_error_string" in p.read_text() for p in _csrc_files()
               if p.name in build.SOURCES)
    assert all((CSRC / s).is_file() for s in build.SOURCES)


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
