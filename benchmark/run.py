"""Run one cell of the benchmark of ``building_detection_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell asks
for.  The cell's files are found by its name (:mod:`benchmark.harness.spec`).
The run makes its inputs and weights from ``--seed``, builds the program
and warms every shape of the window (set-up), runs units of work back to
back until ``--seconds`` have passed (the window; the last unit runs to its
end and the rates divide all the work by all the time), and then:

* with ``--trace 1``, runs more work under ``torch.profiler`` (a stretch
  recording the card alone, then a short one recording the host too,
  :mod:`benchmark.harness.trace`) and reports the cell's per-layer metrics,
  the device's ``busy_s`` and ``window_s`` and a ``breakdown``; with
  ``--trace 0``, its end-to-end metrics;
* frees the program, runs the reference on what the window produced and
  prints each compared number beside its limit, on standard error and under
  ``checks`` (the last key) in the result.

The last line of standard output is the result, one JSON object.  Without a
card, with fewer cards than the cell asks for, or when JAX or the JAX
package got loaded, the run prints no result and exits with a code other
than 0.  Build and kernel caches go under ``build/`` in the checkout.
"""
from __future__ import annotations

import time

START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT)]  # the checkout's root, not benchmark/ itself

from benchmark.harness import guard  # noqa: E402

guard.install()

CACHE = ROOT / "build" / "bench_cache"
GIB = 1024**3


def process_age() -> float:
    """Seconds since this process started (the kernel's start time), else
    since this module was first run."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic() - START


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def run_cell(cell: dict, seed: int, seconds: float, traced: bool, device, card: str = "not read",
             variant=None) -> dict:
    """Set up, measure, trace and check one cell on ``device``; the result.
    ``variant`` plants a fault of the cell's entry (the tests only)."""
    import torch

    from benchmark.harness import compare, spec, trace

    cuda = device.type == "cuda"
    session = spec.entry(cell["entry"]).Session(cell, seed, device, variant=variant)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = process_age()
    say("set-up phases: " + ", ".join(f"{k} {v:.2f} s" for k, v in session.phases.seconds.items()))

    session.begin_window()
    done: dict = {}
    t0 = time.perf_counter()
    units = 0
    while True:
        for k, v in session.unit().items():
            done[k] = done.get(k, 0) + v
        units += 1
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    session.end_window()
    say(f"window: {units} units, {done} in {elapsed:.4f} s; set-up {setup_s:.4f} s")

    summary = None
    if traced:  # the card's share from a stretch without host events, the host's from a short one with them
        holder: dict = {}
        with trace.record(holder, host=False):
            session.trace_unit()
        summary = trace.reduce(holder.pop("events"))
        with trace.record(holder, host=True):
            session.host_trace_unit()
        summary["gaps"] = trace.reduce(holder.pop("events"))["gaps"]
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    session.release()

    t_check = time.perf_counter()
    numbers = session.check()
    say(f"check: {time.perf_counter() - t_check:.2f} s")
    limits = cell["check"]["limits"]
    correct = compare.verdict(numbers, limits)

    ctx = {"cell": cell, "window": {"seconds": elapsed, "done": done}, "trace": summary}
    metrics = {}
    if traced:
        for m in cell["per_layer"]:
            value = spec.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(session.end_to_end(done, elapsed), setup_s=setup_s, peak_mem_gib=peak / GIB)
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": cell["chips"], "memory_peak_bytes": int(peak), "name_and_power_limit": card}
    result = {"correct": bool(correct), "attempted": done[session.requests], "failed": 0,
              "metrics": metrics, "device": dev}
    if summary is not None:
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = trace.breakdown(summary)
    result["checks"] = {k: {"value": numbers.get(k), "limit": v} for k, v in limits.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv"), ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        os.environ[var] = str(CACHE / sub)
    import torch

    from benchmark.harness import spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        say(f"no result: {cell['name']} needs {cell['chips']} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    card = power_limit()
    say(f"card (name, power.limit): {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), card)

    forbidden = guard.loaded()
    if forbidden:
        say(f"no result: modules of JAX or the JAX package were loaded: {forbidden}")
        return 4
    say(f"correct: {result['correct']}")
    for k, v in result["checks"].items():
        say(f"check {k}: {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
