"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell of ``BENCHMARK.json``'s ``workloads`` names a configuration and a
traffic mix; the harness reads

* ``benchmark/configs/<config>.json``: the configuration as it is run;
* ``benchmark/traffic/<mix>.json``: the mix, whose ``entry`` names the
  module ``benchmark/entries/<entry>.py`` that drives the program;
* ``benchmark/workloads/<cell>.json``: the cell's check (its sample and the
  limits of the numbers that decide ``correct``);
* ``benchmark/metrics/<metric>.py``: the reader of each per-layer metric.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import time
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, spec: Dict = None) -> Dict:
    """Everything one cell needs, by name."""
    spec = spec or benchmark()
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(entries)}")
    w = entries[name]
    traffic = load_json(BENCH / "traffic" / f"{w['traffic']}.json")
    return {
        "name": name,
        "chips": int(w["chips"]),
        "config": load_json(BENCH / "configs" / f"{w['config']}.json"),
        "traffic": traffic,
        "check": load_json(BENCH / "workloads" / f"{name}.json")["check"],
        "entry": traffic["entry"],
        "end_to_end": [m for m in spec["end_to_end"] if _applies(m, name)],
        "per_layer": [m for m in spec["per_layer"] if _applies(m, name)],
    }


def entry(name: str):
    return importlib.import_module(f"benchmark.entries.{name}")


def reader(metric: str):
    """The ``read(ctx)`` function of ``benchmark/metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def all_cells(spec: Dict = None) -> List[str]:
    spec = spec or benchmark()
    return [w["name"] for w in spec["workloads"]]


class Phases:
    """Seconds of each named phase of a set-up, on the host clock, each
    ended by a synchronisation of the device."""

    def __init__(self, device):
        self.device, self.seconds, self._t = device, {}, time.perf_counter()

    def mark(self, name: str) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.seconds[name] = now - self._t
        self._t = now
