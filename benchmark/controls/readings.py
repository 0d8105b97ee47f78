"""Readings of a cell's compared numbers: the program's over many seeds, its control's and its faults'.

    python3 benchmark/controls/readings.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--faults fault:half,fault:alter] [--units 1]

runs, in one process on the card, for every seed what a benchmark run of
the cell runs (set-up, ``--units`` units of work with the reservoir of
finished requests open, the check), without timing it, and prints one JSON
line a reading: ``{"seed", "variant", "numbers"}``.  The limits of
``benchmark/workloads/<cell>.json`` are set from these lines: above the
largest that sound runs give, below the smallest that the control gives.

The control, on ``--control-seeds``, is the step a later change would be
tempted by, one precision below the configuration's bf16: the reference
run on float8 e4m3 products in the program's place (read beside a sound
reading of the same seed), and for a ``masks`` cell also the program's own
int8 pointwise path.  ``--faults`` plants the named faults of the
cell's entry on the control seeds.  A benchmark run never runs any of this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[0:1] = [str(ROOT)]

from benchmark.harness import compare, guard, spec  # noqa: E402

guard.install()


def _ints(text: str):
    return [int(t) for t in text.split(",") if t.strip()]


def reading(cell, seed: int, variant, units: int, device, sink, fp8_control: bool = False) -> None:
    """One seed's readings, printed and written to ``sink``."""
    import torch

    t0 = time.perf_counter()
    entry = spec.entry(cell["entry"])
    if cell["entry"] == "train":
        session = entry.Session(cell, seed, device, variant=variant, steps=3)
        session.release()
        ref = session.reference()
        worst: dict = {}
        numbers = session.check(ref, worst)
        lines = [(variant or "program", dict(numbers, worst=worst))]
        if fp8_control:
            fp8 = session.reference(fp8=True)
            lines.append(("control:fp8", compare.train_numbers(
                fp8["loss"], fp8["grad_norms"], fp8["change_norms"],
                ref["loss"], ref["grad_norms"], ref["change_norms"], ref["state"])))
    else:
        session = entry.Session(cell, seed, device, variant=variant)
        session.begin_window()
        for _ in range(units):
            session.unit()
        session.end_window()
        session.release()
        ref = session.margins()
        per_member = {m: compare.mask_numbers([{m: p[m]} for _, p in session.sample], [{m: r[m]} for r in ref])
                      for m in session.members}
        lines = [(variant or "program", dict(session.check(ref), per_member=per_member))]
        if fp8_control:
            fp8 = [{k: (v > 0).to(torch.uint8).numpy() * 255 for k, v in m.items()} for m in session.margins(fp8=True)]
            lines.append(("control:fp8", compare.mask_numbers(fp8, ref)))
    del session
    torch.cuda.empty_cache()
    for name, numbers in lines:
        line = json.dumps({"cell": cell["name"], "seed": seed, "variant": name, "numbers": numbers,
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        sink.write(line + "\n")
        sink.flush()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--faults", default="")
    ap.add_argument("--units", type=int, default=1)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "controls"))
    args = ap.parse_args(argv)
    import torch

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    Path(args.out).mkdir(parents=True, exist_ok=True)
    train = cell["entry"] == "train"
    with open(Path(args.out) / f"{cell['name']}.jsonl", "a") as sink:
        for seed in args.seeds:
            reading(cell, seed, None, args.units, device, sink)
        for seed in args.control_seeds:
            # the fp8 reference beside a sound reading of the same seed
            reading(cell, seed, None, args.units, device, sink, fp8_control=True)
            if not train:
                reading(cell, seed, "int8", args.units, device, sink)
            for fault in filter(None, args.faults.split(",")):
                reading(cell, seed, fault, args.units, device, sink)
    return 0


if __name__ == "__main__":
    sys.exit(main())
