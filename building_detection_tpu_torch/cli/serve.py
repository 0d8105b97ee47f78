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
import os


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
    p.add_argument(
        "--int8", action="store_true",
        help="opt-in int8 pointwise convs at >= 512 input channels (torch._int_mm on the card); "
        "NOT mask-parity",
    )
    p.add_argument(
        "--int8-scales",
        help="JSON calibration scales (pipeline.save_int8_scales, of either package); with --int8 "
        "but no scales, every site takes a dynamic per-call scale",
    )
    p.add_argument(
        "--int8-calibration-dir",
        help="directory of representative images to calibrate on at startup (the first four; "
        "alternative to --int8-scales)",
    )
    p.add_argument("--device", default="cuda", help="torch device to serve from (no fallback)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import dataclasses

    import torch

    from building_detection_tpu_torch.core.config import Config, ServeConfig, TilerConfig
    from building_detection_tpu_torch.core.device import check_device
    from building_detection_tpu_torch.infer.fused_ensemble import DEFAULT_BATCH_TILES
    from building_detection_tpu_torch.infer.pipeline import Pipeline, discover_weights, load_int8_scales
    from building_detection_tpu_torch.serve import server
    from building_detection_tpu_torch.utils import io as uio

    check_device(torch.device(args.device))
    serve_cfg = ServeConfig()
    if args.drain_timeout is not None:
        serve_cfg = dataclasses.replace(serve_cfg, drain_timeout_s=args.drain_timeout)
    cfg = Config(tiler=TilerConfig(bucket_sizes=not args.no_bucket), serve=serve_cfg)
    int8_scales = int8_calibration = None
    if args.int8 and args.int8_scales:
        int8_scales = load_int8_scales(args.int8_scales)
    elif args.int8 and args.int8_calibration_dir:
        names = [f for f in sorted(os.listdir(args.int8_calibration_dir))
                 if f.lower().endswith((".png", ".jpg", ".jpeg", ".tif", ".tiff"))]
        int8_calibration = [uio.imread_rgb(os.path.join(args.int8_calibration_dir, f)) for f in names[:4]]
    pipe = Pipeline(
        weights=discover_weights(args.weights_dir) if args.weights_dir else {},
        cfg=cfg,
        batch_tiles=args.batch_tiles or DEFAULT_BATCH_TILES,
        compute_dtype=torch.bfloat16 if args.precision == "bf16" else torch.float32,
        device=args.device,
        int8_pointwise=512 if args.int8 else False,
        int8_calibration=int8_calibration,
        int8_scales=int8_scales,
    )
    print("模型加载完成 (models loaded)", flush=True)
    server.serve(pipe, cfg, root_dir=args.root_dir, host=args.host, port=args.port)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
