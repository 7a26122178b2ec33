"""The benchmark's data files: BENCHMARK.json against the contract's form,
every configuration, cell, traffic mix, driver and metric reader found by
name, and a new cell found from a new file alone."""

from __future__ import annotations

import json
import os
import shutil

import pytest

from benchmark import harness

IDX = harness.index()
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
KEYS = {
    "configs": ({"name", "source", "file", "reduced", "why"}, set()),
    "workloads": ({"name", "config", "traffic", "chips", "why"}, set()),
    "end_to_end": ({"name", "unit", "better", "bound", "source"}, {"workloads"}),
    "per_layer": ({"name", "unit", "better", "source", "layer", "moves"}, {"workloads"}),
}


def test_benchmark_json_form():
    assert set(IDX) == TOP_KEYS
    assert IDX["paths"] == ["benchmark"] and IDX["command"][1] == "benchmark/run.py"
    assert isinstance(IDX["run_seconds"], int) and 1 <= IDX["run_seconds"] <= 51
    assert len(json.dumps(IDX)) <= 64 * 1024
    for section, (required, optional) in KEYS.items():
        names = [e["name"] for e in IDX[section]]
        assert len(names) == len(set(names)), section
        for e in IDX[section]:
            assert required <= set(e) <= required | optional, (section, e["name"])
            assert harness.NAME_RE.match(e["name"]), e["name"]
            if "unit" in e:
                assert harness.UNIT_RE.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for text in ("why", "layer", "source"):
                if text in e and section in ("configs", "workloads", "per_layer"):
                    assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]


def test_bounds_and_metric_coverage():
    cells = {w["name"] for w in IDX["workloads"]}
    e2e = {m["name"]: m for m in IDX["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in IDX["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for cell in cells:
        reported = [n for n, m in e2e.items() if cell in m.get("workloads", cells)]
        assert "setup_s" in reported and len(reported) >= 2, cell
        layer = [m for m in IDX["per_layer"] if cell in m.get("workloads", cells)]
        assert layer, cell
        for m in layer:
            assert cell in e2e[m["moves"]].get("workloads", cells), (m["name"], cell)
    by_layer = {}
    for m in IDX["per_layer"]:
        by_layer.setdefault(m["layer"], []).append(m["name"])
    assert all(len(v) <= 3 for v in by_layer.values())


@pytest.mark.parametrize("cell", [w["name"] for w in IDX["workloads"]])
def test_cell_files_load(cell):
    w = next(w for w in IDX["workloads"] if w["name"] == cell)
    loaded = harness.load_cell(cell)
    for key in ("config", "traffic", "chips", "why"):
        assert loaded[key] == w[key], key
    assert w["chips"] == 1
    assert harness.NAME_RE.match(w["traffic"]) and harness.NAME_RE.match(w["config"])
    assert loaded["limits"] and all(v >= 0 for v in loaded["limits"].values())
    assert hasattr(harness.load_module("drivers", loaded["driver"]), "Driver")


@pytest.mark.parametrize("entry", IDX["configs"], ids=lambda e: e["name"])
def test_config_files(entry):
    cfg = json.load(open(os.path.join(harness.ROOT, entry["file"])))
    assert entry["file"].startswith("benchmark/configs/")
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] == []
    assert cfg["precision"] == "float32, TF32 off"
    assert set(cfg["solver"]) >= {"max_iters", "tol", "weights", "rom_box"}


@pytest.mark.parametrize("metric", IDX["per_layer"], ids=lambda m: m["name"])
def test_metric_readers_load(metric):
    assert callable(harness.load_module("metrics", metric["name"]).read)


def test_new_cell_found_from_files_alone(tmp_path, monkeypatch):
    """A cell added as data files (workload, mix) is found without an edit of
    the harness."""
    copy = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH_DIR, copy, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (copy / "traffic" / "goals.b16.json").write_text(json.dumps({"kind": "goal_sweep", "batch": 16, "pool": 1}))
    (copy / "workloads" / "sweep.b16.json").write_text(json.dumps(dict(
        config="bench_nlp", traffic="goals.b16", driver="solve_batch", chips=1, why="a test cell",
        limits=dict(knot_gap=1.0, viol_gap=1.0))))
    monkeypatch.setattr(harness, "BENCH_DIR", str(copy))
    cell = harness.load_cell("sweep.b16")
    assert cell["mix"]["batch"] == 16 and cell["cfg"]["name"] == "bench_nlp"
    assert hasattr(harness.load_module("drivers", cell["driver"]), "Driver")


def test_new_traffic_kind_found_from_files_alone(tmp_path, monkeypatch):
    """A traffic kind added as a file (`traffic/<kind>.py`) and a mix of it
    are found without an edit of the generator."""
    from benchmark import traffic

    copy = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH_DIR, copy, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (copy / "traffic" / "fixed_goals.py").write_text(
        "import torch\n\n\ndef make(mix, cfg, g, device):\n"
        "    return torch.full((mix['pool'], mix['batch'], 2), mix['x'], device=device)\n")
    (copy / "traffic" / "fixed.b8.json").write_text(json.dumps({"kind": "fixed_goals", "batch": 8, "pool": 2, "x": 0.5}))
    monkeypatch.setattr(harness, "BENCH_DIR", str(copy))
    mix = json.loads((copy / "traffic" / "fixed.b8.json").read_text())
    goals = traffic.make(mix, harness.load_cell("sweep.b8192")["cfg"], 1, "cpu")
    assert goals.shape == (2, 8, 2) and float(goals.max()) == 0.5


@pytest.mark.parametrize("cell", [w["name"] for w in IDX["workloads"]])
def test_traffic_kind_of_each_cell_is_a_file(cell):
    from benchmark import traffic

    kind = harness.load_cell(cell)["mix"]["kind"]
    assert os.path.exists(os.path.join(harness.BENCH_DIR, "traffic", f"{kind}.py"))
    assert callable(traffic.kind(kind).make)


def test_names_are_checked():
    for bad in ("../x", "a b", "a/b", "", "x" * 65):
        with pytest.raises(ValueError):
            harness.load_cell(bad)
