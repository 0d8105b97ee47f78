"""Dataset augmentation CLI of the port: ``bdt-augment`` (`data_enhancement.py:220-234`).

    python -m building_detection_tpu_torch.cli.augment --images raw/img --labels raw/lab \\
        --out-images aug/img --out-labels aug/lab --split-dir split --seed 0

The flags are ``building_detection_tpu/cli/augment.py``'s; the work is the
port's :class:`~building_detection_tpu_torch.data.augment.DatasetBuilder`,
on the host, so the same seed writes the same files as the JAX CLI.
"""
from __future__ import annotations

import argparse
import os
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bdt-augment",
        description="Offline augmentation + 9:1 train/val split (reference recipe), PyTorch port.",
    )
    p.add_argument("--images", required=True)
    p.add_argument("--labels", required=True)
    p.add_argument("--out-images", required=True)
    p.add_argument("--out-labels", required=True)
    p.add_argument("--split-dir", help="if set, write train/val split under this dir")
    p.add_argument("--split-rate", type=float, default=0.9)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument(
        "--copy-paste",
        action="store_true",
        help="also run the instance-transplant augmentation the reference describes but never "
        "implemented (data_enhancement.py:17-21): buildings from (7.5%%, 20%%]-coverage donors "
        "are copied into <=7.5%%-coverage recipients",
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from building_detection_tpu_torch.data.augment import DatasetBuilder

    t0 = time.time()
    builder = DatasetBuilder(args.images, args.labels, args.out_images, args.out_labels, seed=args.seed)
    n = builder.run()
    print(f"wrote {n} augmented pairs in {time.time() - t0:.1f}s")
    if args.copy_paste:
        print(f"wrote {builder.run_copy_paste()} copy-paste transplant pairs")
    if args.split_dir:
        counts = builder.split_train_val(
            os.path.join(args.split_dir, "train/images"),
            os.path.join(args.split_dir, "train/labels"),
            os.path.join(args.split_dir, "val/images"),
            os.path.join(args.split_dir, "val/labels"),
            args.split_rate,
        )
        print(f"split: {counts[0]} train / {counts[1]} val")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
