"""Serving CLI of the port: ``bdt-serve``, the HTTP service (POST /photo) on the card.

    python -m building_detection_tpu_torch.cli.serve --port 5001 --weights-dir weights/ --device cuda

The flags are ``building_detection_tpu/cli/serve.py``'s (the reference's
`buildAPI.py:232-233`, 0.0.0.0:5001), with ``--device`` added, over the
port's own ``serve/server.py::serve``.  ``--port 0`` binds an ephemeral
port; ``serve`` prints the bound address.  SIGTERM or SIGINT drains the
requests in flight (at most ``--drain-timeout`` seconds) and exits 0.
"""
from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bdt-serve", description="HTTP building-detection service (POST /photo), PyTorch port."
    )
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=5001)
    p.add_argument("--weights-dir")
    p.add_argument("--root-dir", default=".", help="where receive_file/ and all_result/ live")
    p.add_argument(
        "--batch-tiles", type=int, default=None,
        help="tiles per dispatch (default DEFAULT_BATCH_TILES = 32, from the H100's batch sweep)",
    )
    p.add_argument("--precision", choices=["bf16", "f32"], default="bf16")
    p.add_argument(
        "--drain-timeout", type=float, default=None,
        help="seconds to wait for in-flight requests on SIGTERM before closing anyway "
        "(default: ServeConfig.drain_timeout_s = 300)",
    )
    p.add_argument(
        "--no-bucket", action="store_true",
        help="disable bucketed canvas shapes (bucketing lets mixed upload sizes share "
        "dispatch shapes; output is bit-identical)",
    )
    p.add_argument("--int8", action="store_true", help="int8 pointwise convs: slice 3 of the port, refused")
    p.add_argument("--int8-scales", help="int8 calibration scales: slice 3 of the port, refused")
    p.add_argument("--int8-calibration-dir", help="int8 calibration images: slice 3 of the port, refused")
    p.add_argument("--device", default="cuda", help="torch device to serve from (no fallback)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.int8 or args.int8_scales or args.int8_calibration_dir:
        print("--int8, --int8-scales and --int8-calibration-dir are slice 3 of the port, not ported",
              file=sys.stderr)
        return 2
    import dataclasses

    import torch

    from building_detection_tpu_torch.core.config import Config, ServeConfig, TilerConfig
    from building_detection_tpu_torch.core.device import check_device
    from building_detection_tpu_torch.infer.fused_ensemble import DEFAULT_BATCH_TILES
    from building_detection_tpu_torch.infer.pipeline import Pipeline, discover_weights
    from building_detection_tpu_torch.serve import server

    check_device(torch.device(args.device))
    serve_cfg = ServeConfig()
    if args.drain_timeout is not None:
        serve_cfg = dataclasses.replace(serve_cfg, drain_timeout_s=args.drain_timeout)
    cfg = Config(tiler=TilerConfig(bucket_sizes=not args.no_bucket), serve=serve_cfg)
    pipe = Pipeline(
        weights=discover_weights(args.weights_dir) if args.weights_dir else {},
        cfg=cfg,
        batch_tiles=args.batch_tiles or DEFAULT_BATCH_TILES,
        compute_dtype=torch.bfloat16 if args.precision == "bf16" else torch.float32,
        device=args.device,
    )
    print("模型加载完成 (models loaded)", flush=True)
    server.serve(pipe, cfg, root_dir=args.root_dir, host=args.host, port=args.port)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
