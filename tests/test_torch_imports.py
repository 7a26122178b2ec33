"""Import hygiene of the port: qtos_torch, chip_smoke and bench_torch import
neither JAX, flax nor qtos_tpu; the kernels' wrappers reach their build
through `qtos_torch.ops.cuda_lib` alone, and no card tool takes another
tool's private names."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FORBIDDEN = ("jax", "jaxlib", "flax", "qtos_tpu")


# Every module of the port, by name: importing any of them must leave JAX out.
PORT_MODULES = [
    "qtos_torch.builder",
    "qtos_torch.config.experiments",
    "qtos_torch.control.graphs",
    "qtos_torch.control.replan",
    "qtos_torch.runtime.bindings",
    "qtos_torch.utils.containers",
    "qtos_torch.utils.frames",
    "qtos_torch.utils.logger",
    "qtos_torch.utils.profiling",
    "qtos_torch.utils.tracking",
    "qtos_torch.utils.visual",
    "qtos_torch.convert",
    "qtos_torch.device",
    "qtos_torch.entry",
    "qtos_torch.models.solo12",
    "qtos_torch.ops.assemble",
    "qtos_torch.ops.batch_linalg",
    "qtos_torch.ops.btd",
    "qtos_torch.ops.cuda_lib",
    "qtos_torch.ops.lm_restore",
    "qtos_torch.ops.rotations",
    "qtos_torch.ops.splines",
    "qtos_torch.ops.tick",
    "qtos_torch.ops.tridiag",
    "qtos_torch.parallel.distributed",
    "qtos_torch.parallel.mesh",
    "qtos_torch.parallel.worker",
    "qtos_torch.solver.assemble",
    "qtos_torch.solver.gait",
    "qtos_torch.solver.jacobians",
    "qtos_torch.solver.normal_eq",
    "qtos_torch.solver.sampler",
    "qtos_torch.solver.solve",
    "qtos_torch.solver.spec",
    "qtos_torch.solver.transcription",
    "qtos_torch.terrain.heightfield",
    "qtos_torch.terrain.tiles",
    "qtos_torch.sim.motor",
    "qtos_torch.sim.engine",
    "qtos_torch.sim.pybullet_adapter",
    "qtos_torch.sim.pybullet_ui",
    "qtos_torch.control.loop",
    "qtos_torch.planner.astar",
    "qtos_torch.planner.global_planner",
    "qtos_torch.planner.feasibility",
    "qtos_torch.tools.assemble_floor",
    "qtos_torch.tools.btd_floor",
    "qtos_torch.tools.check_assemble",
    "qtos_torch.tools.check_restore",
    "qtos_torch.tools.check_tick",
    "qtos_torch.tools.compare_btd",
    "qtos_torch.tools.crossover",
    "qtos_torch.tools.kit",
    "qtos_torch.tools.profile_solve",
    "qtos_torch.tools.profile_tick",
    "qtos_torch.tools.tick_floor",
    "qtos_torch.tools.riser",
]


# The changing world's benchmark cell `replan.exp8` and its tests: the driver,
# its traffic kind, the reference's box, the replay share's reader.
WORLD_CELL_SOURCES = [
    ("benchmark", "drivers", "plan_windows_world.py"),
    ("benchmark", "traffic", "replans_world.py"),
    ("benchmark", "reference", "world.py"),
    ("benchmark", "metrics", "replay_pct.exp8.py"),
    ("benchmark", "tests", "test_bench_world.py"),
    ("tests", "test_torch_world.py"),
]


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "bench_torch.py")]
    out += [os.path.join(REPO, "scripts", f"{name}_torch.py") for name in ("main", "record", "sweep", "towr_deviation")]
    out += [os.path.join(REPO, *parts) for parts in WORLD_CELL_SOURCES]
    for root, _, files in os.walk(os.path.join(REPO, "qtos_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("module", ["qtos_torch", "chip_smoke", "bench_torch"])
def test_import_leaves_jax_out(module):
    code = (
        "import sys, importlib\n"
        "importlib.import_module(sys.argv[1])\n"
        "for name in sys.argv[2:]:\n"
        "    importlib.import_module(name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code, module, *PORT_MODULES], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imports(path):
    """(module, imported names) of every import statement of the file."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(a.name, ()) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            out.append((node.module or "", tuple(a.name for a in node.names)))
    return out


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_sources_do_not_import_jax(path):
    for module, _ in _imports(path):
        assert module.split(".")[0] not in FORBIDDEN, f"{path} imports {module}"


def test_module_list_covers_the_package():
    """PORT_MODULES names every module file of qtos_torch (packages are
    imported with their modules)."""
    found = set()
    for path in _port_sources():
        rel = os.path.relpath(path, REPO)
        if rel.startswith("qtos_torch") and not rel.endswith("__init__.py"):
            found.add(rel[:-3].replace(os.sep, "."))
    assert found == set(PORT_MODULES)


def test_towr_deviation_script_leaves_jax_out(tmp_path):
    """scripts/towr_deviation_torch.py, loaded as a file and run through
    `measure` on the CPU (a 0.2 s window of a standing table, one LM
    iteration), pulls in neither JAX nor qtos_tpu."""
    import numpy as np

    table = np.zeros((301, 37))
    table[:, 0] = np.arange(301) * 1e-3
    table[:, 3] = 0.24
    table[:, 7:19] = np.tile([[0.21, 0.19, 0.0], [0.21, -0.19, 0.0], [-0.21, 0.19, 0.0], [-0.21, -0.19, 0.0]],
                             (301, 1, 1)).reshape(301, 12)
    table[:, 27:37:3] = 7.4
    golden = tmp_path / "golden.csv"
    np.savetxt(golden, table, delimiter=",")
    code = (
        "import runpy, sys\n"
        "mod = runpy.run_path(sys.argv[1])\n"
        "out, res, spec = mod['measure'](0.2, 5, 1, 0, golden=sys.argv[2], device='cpu')\n"
        "assert set(out) >= {'status', 'com_rms', 'end_dev'}, out\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code, os.path.join(REPO, "scripts", "towr_deviation_torch.py"),
                           str(golden)], cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=""),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("wrapper,other", [("tick", "btd"), ("assemble", "tick"), ("lm_restore", "tick")])
def test_kernel_wrappers_build_through_cuda_lib_alone(wrapper, other):
    """A wrapper finds its compiler in `cuda_lib`, not in another kernel's
    wrapper (assembly and the restore would otherwise import the simulator
    through the tick's)."""
    imports = _imports(os.path.join(REPO, "qtos_torch", "ops", f"{wrapper}.py"))
    reached = {mod for mod, _ in imports} | {f"{mod}.{name}" for mod, names in imports for name in names}
    assert f"qtos_torch.ops.{other}" not in reached and "qtos_torch.ops.cuda_lib" in reached


TOOLS = sorted(f[:-3] for f in os.listdir(os.path.join(REPO, "qtos_torch", "tools"))
               if f.endswith(".py") and f != "__init__.py")


@pytest.mark.parametrize("tool", TOOLS)
def test_tools_take_no_private_name_of_another_tool(tool):
    for mod, names in _imports(os.path.join(REPO, "qtos_torch", "tools", f"{tool}.py")):
        if mod.startswith("qtos_torch.tools.") and mod != f"qtos_torch.tools.{tool}":
            assert not [n for n in names if n.startswith("_")], f"{tool} imports {names} from {mod}"
