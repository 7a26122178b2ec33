"""bench_torch.py, the port's counterpart of bench.py, on the CPU: its
distribution against qtos_tpu's, its settings against bench.py's source, its
output and exit codes, and the BTD work count it shares with chip_smoke.py.

Tolerance of the spec comparison: atol=1e-6, the float32 rounding of goals
that `jnp.linspace` and `torch.linspace` compute each in their own way."""

import ast
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtos_tpu.solver import default_spec as j_default_spec
from qtos_tpu.terrain import make_terrain as j_make_terrain

from qtos_torch.convert import spec_from_reference
from qtos_torch.ops.btd import work

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)
import bench_torch  # noqa: E402

sys.path.pop(0)

ATOL = 1e-6
KEYS = ["metric", "value", "unit", "vs_baseline"]


def _leaves(obj, prefix=""):
    """(name, array) of every tensor leaf of a spec, in field order."""
    import dataclasses

    if isinstance(obj, torch.Tensor):
        return [(prefix, obj.numpy())]
    if dataclasses.is_dataclass(obj):
        return [leaf for f in dataclasses.fields(obj) for leaf in _leaves(getattr(obj, f.name), f"{prefix}.{f.name}")]
    return [(prefix, obj)]


def test_build_specs_matches_the_reference_distribution():
    B = 8
    jterr = j_make_terrain(["plane", "plane", "plane"])
    jspecs = jax.vmap(lambda g: j_default_spec(jterr, goal_xy=(g, 0.0), K=41))(jnp.linspace(0.3, 0.8, B))
    ref = spec_from_reference(jax.tree_util.tree_map(np.asarray, jspecs), device="cpu")
    specs, terrain = bench_torch.build_specs(B, "cpu")
    assert terrain.device.type == "cpu" and specs.num_knots == 41
    got, want = _leaves(specs), _leaves(ref)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        if isinstance(b, np.ndarray):
            b = np.asarray(b)
            # the port shares one schedule across the batch; the reference's is vmapped
            np.testing.assert_allclose(np.broadcast_to(a, b.shape), b, atol=ATOL, err_msg=name)
        else:
            assert a == pytest.approx(b), name


def _bench_settings() -> dict:
    """bench.py's literal settings, read from its source without running it."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Constant):
            out[node.targets[0].id] = node.value.value
        if not isinstance(node, ast.Call):
            continue
        name = ast.unparse(node.func)
        if name == "make_terrain":
            out["tiles"] = ast.literal_eval(node.args[0])
        elif name == "SolverConfig":
            out["cfg"] = {k.arg: ast.literal_eval(k.value) for k in node.keywords}
        elif name == "jnp.linspace":
            out["goals"] = tuple(ast.literal_eval(a) for a in node.args[:2])
        elif name == "default_spec":
            goal = next(k.value for k in node.keywords if k.arg == "goal_xy")
            out["goal_y"] = ast.literal_eval(goal.elts[1])
        elif name == "os.environ.get":
            out["batches"] = tuple(ast.literal_eval(a) for a in node.args)
    return out


def test_settings_are_bench_py_s():
    ref = _bench_settings()
    cfg = bench_torch.solver_config()
    assert ref["tiles"] == bench_torch.TILES
    assert ref["K"] == bench_torch.K
    assert ref["cfg"] == {"max_iters": cfg.max_iters, "rescue_iters": cfg.rescue_iters}
    assert ref["goals"] == bench_torch.GOALS and ref["goal_y"] == 0.0
    assert ref["BASELINE_SOLVES_PER_S"] == bench_torch.BASELINE_SOLVES_PER_S
    assert ref["batches"] == ("QTOS_BENCH_BATCHES", bench_torch.DEFAULT_BATCHES)


def _run(monkeypatch, capsys, argv):
    monkeypatch.setenv("QTOS_BENCH_BATCHES", "2")
    monkeypatch.setattr(bench_torch, "REPEATS", 1)
    rc = bench_torch.main(argv)
    return rc, capsys.readouterr().out.strip().splitlines()


def test_main_on_the_cpu_prints_bench_py_s_line(monkeypatch, capsys):
    rc, lines = _run(monkeypatch, capsys, ["--device", "cpu"])
    assert rc == 0
    assert lines[0] == "# device cpu"
    assert lines[1].startswith("# B=2: ") and "(2/2 converged)" in lines[1] and "GFLOP pass-1" in lines[1]
    assert "% of f32 peak" not in lines[1]            # the card's peak is not a CPU figure
    out = json.loads(lines[-1])
    assert list(out) == KEYS
    assert out["metric"] == "gait_nlp_solves_per_s" and out["unit"] == "solves/s/chip" and out["value"] > 0
    assert abs(out["vs_baseline"] - out["value"] / 1.3) <= 0.1      # both rounded to 0.1, as bench.py does


def test_main_exits_1_when_a_scenario_does_not_converge(monkeypatch, capsys):
    """A solve whose second scenario ends unconverged (status 1)."""
    monkeypatch.setattr(bench_torch, "solve_batch",
                        lambda specs, terrain, cfg: types.SimpleNamespace(status=torch.tensor([0, 1])))
    rc, lines = _run(monkeypatch, capsys, ["--device", "cpu"])
    assert rc == 1
    assert "(1/2 converged)" in lines[1]
    assert list(json.loads(lines[-1])) == KEYS


def test_time_solves_counts_each_call():
    specs, terrain = bench_torch.build_specs(2, "cpu")
    t = bench_torch.time_solves(specs, terrain, bench_torch.solver_config(), repeats=1)
    assert t["B"] == 2 and t["converged"] == 2 and len(t["seconds"]) == 1 and min(t["seconds"]) > 0
    assert t["btd_launches"] == t["assemble_launches"] == t["restore_launches"] == [0]  # the CPU runs the plain versions
    assert tuple(t["result"].x.shape) == (2, 41, 36)


@pytest.mark.parametrize("restore", [[3, 3], [3, 2]])
def test_chip_smoke_reads_the_launch_line(restore):
    """chip_smoke.py's phase 11 gate parses `describe`'s `# B=` line: the
    three solver kernels' launches per call must be equal."""
    sys.path.insert(0, REPO)
    import chip_smoke

    sys.path.pop(0)
    t = dict(B=8, seconds=[0.5, 0.4], converged=8, btd_launches=[3, 3], assemble_launches=[3, 3],
             restore_launches=restore, small_btd_launches=[0, 0])
    assert chip_smoke.bench_line_ok(bench_torch.describe(t, 10**9, False)) == (restore == [3, 3])


def test_without_a_card_the_script_exits_non_zero():
    """No card and no --device: the script stops with resolve_device's error
    and prints no result; it does not run on the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", QTOS_BENCH_BATCHES="2")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "bench_torch.py")], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "gait_nlp_solves_per_s" not in proc.stdout


def test_pass1_flops_from_the_kernels_shapes():
    nbytes, flops = work(8192, 41, 36)
    assert round(nbytes / 1e9, 3) == 3.537 and round(flops / 1e9, 2) == 40.09       # the kernel's bound in PERF.md
    total = bench_torch.pass1_flops(8192, bench_torch.solver_config())
    assert round(total / 1e9, 1) == round(3 * (40.089157632 + 31.1427072), 1)       # BTD + Gram, 3 iterations
