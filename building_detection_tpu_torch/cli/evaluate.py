"""Evaluation CLI of the port: PA/IoU/MIoU/F1 of a checkpoint over an image/label set.

    python -m building_detection_tpu_torch.cli.evaluate res34 --checkpoint weights1/epoch_30_weights.npz \\
        --images data/val/img --labels data/val/lab --device cuda

The flags are ``building_detection_tpu/cli/evaluate.py``'s, with
``--device`` added; it prints one JSON line.  Whole batches only, as the
reference's validation steps: the ``len % batch`` tail is not evaluated,
and ``samples`` says how many were.

Data-parallel evaluation runs one worker per device, as ``bdt-train``
does: with no process flags over every visible card (``--local-devices K``
workers started by ``parallel/launch.py``, capped at ``gcd(batch size,
K)``), over several processes with the same arguments plus ``--coordinator
HOST:PORT --num-processes N --process-id I`` (one worker a process, or
``--local-devices K`` each), or ``--num-processes 0`` under ``torchrun``;
NCCL for cards and Gloo for ``--device cpu``.  Every worker reads the same
whole batches and evaluates its rows of each; the metrics and the loss are
reduced over the workers, and rank 0 alone prints the line.
"""
from __future__ import annotations

import argparse
import json

from building_detection_tpu_torch.cli.train import add_process_flags, run


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bdt-eval", description="Evaluate a checkpoint on an image/label dir (PyTorch port)."
    )
    p.add_argument("model", choices=["res34", "hrnet", "v3plus", "scse", "bam"])
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--images", required=True)
    p.add_argument("--labels", required=True)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--image-size", type=int, default=512)
    p.add_argument("--precision", choices=["bf16", "f32"], default="f32")
    p.add_argument("--device", default="cuda", help="torch device to evaluate on (no fallback)")
    p.add_argument(
        "--data-parallel", type=int, default=-1,
        help="processes on the data axis (-1: all, capped at gcd(batch size, processes))",
    )
    add_process_flags(p, "evaluation")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    return run(parser, parser.parse_args(argv), evaluate, "evaluation")


def evaluate(args) -> int:
    import torch

    from building_detection_tpu_torch.core.config import TrainConfig
    from building_detection_tpu_torch.data.dataset import batch_iterator, list_pairs
    from building_detection_tpu_torch.parallel import distributed as pdist
    from building_detection_tpu_torch.parallel.mesh import make_mesh
    from building_detection_tpu_torch.train.trainer import Trainer

    pairs = list_pairs(args.images, args.labels)
    steps = max(len(pairs) // args.batch_size, 1)
    trainer = Trainer(
        args.model,
        TrainConfig(batch_size=args.batch_size, image_size=args.image_size),
        steps_per_epoch=steps,
        mesh=make_mesh(data=args.data_parallel, batch_size=args.batch_size),
        compute_dtype=torch.bfloat16 if args.precision == "bf16" else torch.float32,
        device=args.device,
    )
    trainer.restore(args.checkpoint)
    it = batch_iterator(pairs, args.batch_size, args.image_size)
    agg = {}
    for _ in range(steps):
        for k, v in trainer.eval_on_batch(*next(it)).items():
            agg[k] = agg.get(k, 0.0) + v
    agg = {k: round(v / steps, 6) for k, v in agg.items()}
    agg["samples"] = min(steps * args.batch_size, len(pairs))
    if pdist.is_primary():
        print(json.dumps(agg))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
