"""Import hygiene of the port: qtos_torch and chip_smoke import neither JAX,
flax nor qtos_tpu."""

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
    "qtos_torch.control.loop",
    "qtos_torch.planner.astar",
    "qtos_torch.planner.global_planner",
    "qtos_torch.planner.feasibility",
    "qtos_torch.tools.assemble_floor",
    "qtos_torch.tools.check_assemble",
    "qtos_torch.tools.check_tick",
    "qtos_torch.tools.compare_btd",
    "qtos_torch.tools.crossover",
    "qtos_torch.tools.profile_solve",
    "qtos_torch.tools.profile_tick",
    "qtos_torch.tools.tick_floor",
    "qtos_torch.tools.riser",
]


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    out += [os.path.join(REPO, "scripts", f"{name}_torch.py") for name in ("main", "record", "sweep")]
    for root, _, files in os.walk(os.path.join(REPO, "qtos_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("module", ["qtos_torch", "chip_smoke"])
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


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_sources_do_not_import_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


def test_module_list_covers_the_package():
    """PORT_MODULES names every module file of qtos_torch (packages are
    imported with their modules)."""
    found = set()
    for path in _port_sources():
        rel = os.path.relpath(path, REPO)
        if rel.startswith("qtos_torch") and not rel.endswith("__init__.py"):
            found.add(rel[:-3].replace(os.sep, "."))
    assert found == set(PORT_MODULES)
