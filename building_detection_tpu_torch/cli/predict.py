"""Batch prediction CLI of the port: ``bdt-predict``, directory in, files out.

    python -m building_detection_tpu_torch.cli.predict --image-dir scenes/ \\
        --out results/ --weights-dir weights/ --device cuda

The flags are ``building_detection_tpu/cli/predict.py``'s (the reference's
`predict.py:135-181` with flags for its hard-coded paths; mode '1' is
``--image``, mode '2' ``--image-dir``), with ``--device`` added.  Each scene
``NAME`` writes ``OUT/NAME/NAME_result.png`` and ``OUT/NAME/NAME.txt`` (and
the five per-model masks with ``--keep-intermediates``), and prints one JSON
line.

Sharding differs from the JAX CLI's: with ``--num-processes N`` a scene goes
to the process ``zlib.crc32(file name) % N``, not to a position in the
sorted listing, so a file added to the directory between two shards' runs
moves no other file to another shard.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import zlib

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".tif", ".tiff", ".bmp")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bdt-predict",
        description="5-model ensemble building detection over GeoTIFF/PNG scenes (PyTorch port).",
    )
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--image", help="single image to predict (reference mode '1')")
    src.add_argument("--image-dir", help="directory of images to predict (reference mode '2')")
    p.add_argument("--out", required=True, help="result directory")
    p.add_argument(
        "--weights-dir",
        help="directory with {model}.npz checkpoints (res34/hrnet/v3plus/scse/bam); "
        "missing models run with random weights",
    )
    p.add_argument(
        "--batch-tiles", type=int, default=None,
        help="tiles per dispatch (default DEFAULT_BATCH_TILES = 32, from the H100's "
        "batch sweep; the JAX CLI's 8 was a TPU choice)",
    )
    p.add_argument(
        "--precision", choices=["bf16", "f32"], default="bf16",
        help="activation dtype: bf16 for speed, f32 for bit-parity",
    )
    p.add_argument(
        "--keep-intermediates", action="store_true",
        help="keep per-model masks (the reference deletes them, predict.py:174-178)",
    )
    p.add_argument(
        "--fast-vote", action="store_true",
        help="skip the reference's per-model morphological cleanup and write the plain "
        "3-of-5 vote (faster; NOT mask-parity)",
    )
    p.add_argument("--config", help="JSON config overriding the reference constants")
    p.add_argument(
        "--int8", action="store_true",
        help="opt-in int8 pointwise convs at >= 512 input channels (torch._int_mm on the card), "
        "calibrated on the first two scenes (of this shard); NOT mask-parity",
    )
    p.add_argument(
        "--bucket", action="store_true",
        help="bucket canvas shapes so mixed scene sizes share dispatch shapes (bit-identical output)",
    )
    p.add_argument(
        "--num-processes", type=int, default=1,
        help="number of bdt-predict processes sharing this --image-dir; each takes the scenes "
        "whose crc32(file name) %% N is its --process-id (no coordination; the union of all "
        "shards' outputs equals one big run)",
    )
    p.add_argument("--process-id", type=int, default=0, help="this process's shard in [0, --num-processes)")
    p.add_argument(
        "--chunk-scenes", type=int, default=16,
        help="decode/predict/write this many scenes at a time, so host memory stays O(chunk); "
        "0 = one chunk",
    )
    p.add_argument("--device", default="cuda", help="torch device to predict on (no fallback)")
    return p


def shard_of(path: str, num_processes: int) -> int:
    """The process a scene belongs to: a stable hash of its file name."""
    return zlib.crc32(os.path.basename(path).encode("utf-8")) % num_processes


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import dataclasses

    import torch

    from building_detection_tpu_torch.core.config import Config
    from building_detection_tpu_torch.core.device import check_device
    from building_detection_tpu_torch.data.dataset import prefetch
    from building_detection_tpu_torch.infer.fused_ensemble import DEFAULT_BATCH_TILES
    from building_detection_tpu_torch.infer.pipeline import Pipeline, PredictResult, discover_weights
    from building_detection_tpu_torch.post import edges as E
    from building_detection_tpu_torch.utils import io as uio

    check_device(torch.device(args.device))
    cfg = Config.from_json(args.config) if args.config else Config()
    if args.bucket:
        cfg = dataclasses.replace(cfg, tiler=dataclasses.replace(cfg.tiler, bucket_sizes=True))

    if args.image:
        images = [args.image]
    else:
        images = [
            os.path.join(args.image_dir, f)
            for f in sorted(os.listdir(args.image_dir))
            if f.lower().endswith(IMAGE_EXTS)
        ]
    if args.num_processes < 1 or not (0 <= args.process_id < args.num_processes):
        print(f"--process-id {args.process_id} must be in [0, --num-processes={args.num_processes})",
              file=sys.stderr)
        return 2
    if args.num_processes > 1:
        if args.image:
            print("--num-processes applies to --image-dir runs (a single --image has nothing to shard)",
                  file=sys.stderr)
            return 2
        total = len(images)
        images = [p for p in images if shard_of(p, args.num_processes) == args.process_id]
        print(f"process {args.process_id}/{args.num_processes}: {len(images)} of {total} scenes", file=sys.stderr)
        if not images and total:
            return 0  # an empty shard is a clean no-op: the fleet's union is still complete
    if not images:
        print("no images found", file=sys.stderr)
        return 2

    pipe = Pipeline(
        weights=discover_weights(args.weights_dir) if args.weights_dir else {},
        cfg=cfg,
        batch_tiles=args.batch_tiles or DEFAULT_BATCH_TILES,
        compute_dtype=torch.bfloat16 if args.precision == "bf16" else torch.float32,
        device=args.device,
        # 512 input channels: the Xception projections, as in the JAX CLI
        int8_pointwise=512 if args.int8 else False,
        # the first scenes double as the int8 calibration set
        int8_calibration=[uio.imread_rgb(p) for p in images[:2]] if args.int8 else None,
    )

    def predict_chunk(arrays):
        if not args.fast_vote:
            return pipe.predict_images(arrays)
        results = []
        for arr in arrays:
            fused = pipe.ensemble.predict_vote(arr, cfg.fuse.vote_threshold)
            corners, height = E.extract_polygons(fused, cfg.edge)
            results.append(PredictResult({}, fused, corners, height))
        return results

    # CHUNK scenes at a time: host memory O(chunk) over any directory, each
    # chunk still filling grouped dispatches; a depth-1 prefetch decodes
    # chunk N+1 on a thread while chunk N is on the device.
    chunk = args.chunk_scenes if args.chunk_scenes > 0 else len(images)

    def decoded_chunks():
        for lo in range(0, len(images), chunk):
            paths = images[lo : lo + chunk]
            yield paths, [uio.imread_rgb(p) for p in paths]

    for paths, arrays in prefetch(decoded_chunks(), depth=1):
        for path, result in zip(paths, predict_chunk(arrays)):
            name = os.path.splitext(os.path.basename(path))[0]
            out_dir = os.path.join(args.out, name)
            os.makedirs(out_dir, exist_ok=True)
            if args.keep_intermediates:
                for model_name, mask in result.masks.items():
                    uio.imwrite(os.path.join(out_dir, f"{model_name}_{name}.png"), mask)
            uio.imwrite(os.path.join(out_dir, f"{name}_result.png"), result.fused)
            uio.write_points(result.corners, os.path.join(out_dir, f"{name}.txt"))
            print(json.dumps({
                "image": path,
                "result": os.path.join(out_dir, f"{name}_result.png"),
                "points": os.path.join(out_dir, f"{name}.txt"),
                "num_buildings": len(result.corners),
            }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
