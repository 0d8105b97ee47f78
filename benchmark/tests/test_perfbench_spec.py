"""The benchmark's files, found by name, and what a run prints (CPU)."""
from __future__ import annotations

import ast
import json
import re
import subprocess
import sys

import pytest
import torch

from benchmark import run
from benchmark.harness import guard, readers, spec, traffic
from benchmark.tests import tiny

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CONTRACT_KEYS = {"correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"}


def test_benchmark_json_has_the_contract_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [m["name"] for m in BENCH["end_to_end"]] + METRICS
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_are_found_by_name(name):
    cell = spec.cell(name)
    assert cell["config"]["name"] == next(w["config"] for w in BENCH["workloads"] if w["name"] == name)
    assert cell["config"]["reduced"] == []
    assert hasattr(spec.entry(cell["entry"]), "Session")
    assert cell["check"]["limits"] and all(v > 0 for v in cell["check"]["limits"].values())
    reported = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2 and cell["per_layer"]


@pytest.mark.parametrize("name", METRICS)
def test_metric_readers_are_found_and_read_nothing_from_nothing(name):
    read = spec.reader(name)
    cell = spec.cell(next(c for c in CELLS if c in next(m for m in BENCH["per_layer"] if m["name"] == name)
                          .get("workloads", CELLS)))
    assert read({"cell": cell, "window": {"seconds": 1.0, "done": {}}, "trace": None}) is None


def test_idle_share_reads_the_trace():
    ctx = {"trace": {"window_s": 2.0, "busy_s": 1.5}}
    assert readers.idle_percent(ctx) == pytest.approx(25.0)


@pytest.mark.parametrize("mix", ["masks-1024", "train-512-b8"])
def test_traffic_repeats_for_a_seed_and_moves_with_it(mix):
    p = dict(spec.load_json(spec.BENCH / "traffic" / f"{mix}.json")["scene"], buildings=3, ground_cell_px=16)
    a = traffic.scenes(p, 2**33 + 5, 3, 48, "cpu")
    b = traffic.scenes(p, 2**33 + 5, 3, 48, "cpu")
    c = traffic.scenes(p, 2**33 + 6, 3, 48, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert a[0].dtype == torch.uint8 and set(a[1].unique().tolist()) <= {0, 255}


def test_nothing_the_benchmark_imports_is_jax_or_the_jax_package():
    code = (
        "import pkgutil, importlib, sys; sys.path.insert(0, '.'); import benchmark.run; "
        "import benchmark.controls.readings; "
        "[importlib.import_module(m.name) for m in pkgutil.walk_packages(['benchmark'], 'benchmark.') "
        "if '.tests' not in m.name]; "
        "from benchmark.harness import spec; [spec.reader(m['name']) for m in spec.benchmark()['per_layer']]; "
        "import building_detection_tpu_torch.infer.fused_ensemble, building_detection_tpu_torch.train.trainer; "
        "from benchmark.harness import guard; print(guard.loaded())"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=spec.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_guard_refuses_jax_and_the_jax_package_by_whole_top_level_name():
    code = (
        "import sys; sys.path.insert(0, '.'); from benchmark.harness import guard; guard.install(); "
        "import building_detection_tpu_torch.core.config\n"
        "for name in ('jax', 'building_detection_tpu.core.config', 'flax'):\n"
        "    try:\n        __import__(name)\n    except ImportError:\n        print('refused', name)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=spec.ROOT, timeout=120)
    assert out.stdout.split("\n")[:3] == ["refused jax", "refused building_detection_tpu.core.config", "refused flax"]
    assert guard.top("building_detection_tpu_torch.x") not in guard.FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    banned = guard.FORBIDDEN | {"building_detection_tpu_torch"}
    for path in sorted((spec.BENCH / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not {guard.top(n) for n in names} & banned, (path.name, names)


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("name", ["ensemble5.masks-1024", "res34.train-512-b8"])
def test_a_run_prints_only_the_contract_keys_with_the_checks_last(name, traced):
    result = run.run_cell(tiny.cell(name), 2**31 + 77, 0.05, traced, torch.device("cpu"))
    line = json.loads(json.dumps(result))
    assert set(line) <= CONTRACT_KEYS and list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["checks"]) == set(spec.cell(name)["check"]["limits"])
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"]) and set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {m["name"] for m in spec.cell(name)["end_to_end"]}


def _run(cwd, seconds="1"):
    cmd = [sys.executable, "benchmark/run.py", "--workload", "res34.train-512-b8", "--seed", "2147483659",
           "--seconds", seconds, "--trace", "0"]
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=900)


def test_without_the_program_or_a_card_a_run_prints_no_result(tmp_path):
    import shutil

    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card(card):
    out = _run(spec.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
