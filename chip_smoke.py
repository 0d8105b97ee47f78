#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``building_detection_tpu_torch``) on one CUDA card.

Usage, from the root of a checkout, with one card visible:

    python3 chip_smoke.py

It builds the port's hand-written kernel from ``building_detection_tpu_torch/csrc``
with ``nvcc``, checks it against its plain PyTorch twin on the card, and drives
the port's main path at full width: the five-member ensemble through
``Pipeline.predict_images`` on 512x512 tiles in bf16 (random weights from a
seed), and the training targets through ``make_targets``, whose edge-band
maps run the kernel.  It imports nothing of JAX.  Any failed check exits
non-zero before the result lines.  The second-to-last line is a JSON object
with each kernel's launches on the main path, its error against the twin and
both times; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import time

SEED = 0
SWEEP = (8, 16, 32, 64)           # batch_tiles values timed on the ensemble forward
PARITY_ATOL = 1e-3                # f32 card vs CPU, ~100 layers summed in other orders
EDGE_SHAPE = (8, 512, 512)        # the trainer's label batch


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def labels_np(seed: int, shape) -> "np.ndarray":
    """{0,1} f32 labels: random blobs grown by one 3x3 dilation (numpy only)."""
    import numpy as np

    n, h, w = shape
    lab = np.random.RandomState(seed).rand(n, h, w) < 0.35
    pad = np.pad(lab, ((0, 0), (1, 1), (1, 1)))
    grown = np.zeros_like(lab)
    for dy in range(3):
        for dx in range(3):
            grown |= pad[:, dy : dy + h, dx : dx + w]
    return grown.astype(np.float32)


def cuda_ms(fn, runs: int, flush=None) -> float:
    """Median milliseconds of ``fn()`` over ``runs`` timed runs (CUDA events),
    after one warm-up; ``flush()`` runs untimed before each."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        if flush is not None:
            flush()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    name = torch.cuda.get_device_name(0)
    say("device", f"{name}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
                  f"{torch.cuda.device_count()} visible")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    for mod in ("PIL", "cv2"):
        try:
            __import__(mod)
            say("device", f"{mod} importable")
        except ImportError:
            say("device", f"{mod} absent")
    from building_detection_tpu.post import geometry

    say("device", "native geometry library " + ("loaded" if geometry._nat is not None else "absent: numpy fallback"))
    return name, smi_line


def phase_build():
    from building_detection_tpu_torch.kernels import edge_weights as K

    t0 = time.perf_counter()
    K.load_library()
    say("build", f"edge_weights.cu built and loaded in {time.perf_counter() - t0:.1f} s")


def phase_edge_check():
    """Kernel vs plain twin on the card at the trainer's shape, and times."""
    import torch

    from building_detection_tpu_torch.kernels import edge_weights as K

    lab = torch.from_numpy(labels_np(SEED, EDGE_SHAPE)).cuda()
    got = K.edge_weight_maps(lab)
    want = K.edge_weight_maps_plain(lab)
    torch.cuda.synchronize()
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    for g, w in zip(got, want):
        check(torch.equal(g, w), "edge_weight_maps kernel differs from its plain twin")
    for kernel, iters, weight in ((2, 4, 3.0), (5, 2, 1.5)):
        odd = torch.from_numpy(labels_np(SEED + 1, (3, 77, 131))).cuda()
        for g, w in zip(K.edge_weight_maps(odd, kernel, iters, weight),
                        K.edge_weight_maps_plain(odd, kernel, iters, weight)):
            check(torch.equal(g, w), f"kernel differs from twin at kernel={kernel} x{iters}")
    scratch = torch.empty(64 << 20, dtype=torch.float32, device="cuda")  # 256 MB > L2
    flush = scratch.zero_
    ms = cuda_ms(lambda: K.edge_weight_maps(lab), 30, flush)
    plain_ms = cuda_ms(lambda: K.edge_weight_maps_plain(lab), 30, flush)
    say("edge", f"kernel bit-equal to plain at {EDGE_SHAPE}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                f"(median of 30, L2 flushed before each)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_normalize():
    import numpy as np
    import torch

    from building_detection_tpu_torch.ops import tiling as T

    v = np.arange(256, dtype=np.uint8)
    want = (v.astype(np.float64) / 127.5 - 1.0).astype(np.float32)
    got = T.normalize(torch.from_numpy(v).cuda()).cpu().numpy()
    check(np.array_equal(got.view(np.uint32), want.view(np.uint32)), "normalize is not bit-exact on the card")
    say("normalize", "all 256 uint8 values bit-exact on the card")


def phase_parity():
    """Each member at full width and depth, same seeded weights, card vs CPU, f32."""
    import numpy as np
    import torch

    from building_detection_tpu_torch.models.registry import ENSEMBLE_ORDER, init_model

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say("parity", "TF32 off for cuDNN convs and matmuls")
    x = torch.from_numpy(np.random.RandomState(SEED).uniform(-1, 1, (1, 128, 128, 3)).astype(np.float32))
    try:
        for i, name in enumerate(ENSEMBLE_ORDER):
            model = init_model(name, torch.Generator().manual_seed(SEED + i))
            with torch.inference_mode():
                ref = model(x)
                got = copy.deepcopy(model).cuda()(x.cuda()).cpu()
            check(bool(torch.isfinite(got).all()), f"{name}: non-finite softmax on the card")
            diff = float((got - ref).abs().max())
            say("parity", f"{name}: max |softmax card - softmax cpu| = {diff:.3e} (atol {PARITY_ATOL})")
            check(diff <= PARITY_ATOL, f"{name}: card and CPU disagree by {diff}")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def scenes():
    import numpy as np

    rng = np.random.RandomState(SEED)
    shapes = [(1024, 1024), (1024, 1024), (700, 1300), (100, 100)]
    return [rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for h, w in shapes]


def check_results(imgs, results, names):
    import numpy as np

    check(len(results) == len(imgs), "predict_images lost a scene")
    for img, res in zip(imgs, results):
        h, w = img.shape[:2]
        check(list(res.masks) == list(names), "member masks missing")
        for m in list(res.masks.values()) + [res.fused]:
            check(m.shape == (h, w) and m.dtype == np.uint8, f"mask shape {m.shape} {m.dtype} for a {h}x{w} scene")
            check(set(np.unique(m).tolist()) <= {0, 255}, "mask values outside {0, 255}")
        check(res.height == h, "height is not the scene height")
        for ring in res.corners:
            xs, ys = ring
            check(len(xs) == len(ys) >= 2 and xs[0] == xs[-1] and ys[0] == ys[-1], "polygon ring not closed")
    blank = results[-1]
    check(not any(m.any() for m in blank.masks.values()) and not blank.fused.any() and blank.corners == [],
          "the 100x100 scene (no tile) is not blank")


def phase_main_path(pipe):
    """The counted run: the port's entry points, once each, on the card."""
    import torch

    from building_detection_tpu.core.config import TrainConfig
    from building_detection_tpu_torch.kernels import edge_weights as K
    from building_detection_tpu_torch.train.trainer import make_targets

    imgs = scenes()
    labels_u8 = (torch.from_numpy(labels_np(SEED + 2, EDGE_SHAPE)) * 255).to(torch.uint8)
    K.edge_weight_maps.launches = 0
    t0 = time.perf_counter()
    results = pipe.predict_images(imgs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    y_true = make_targets(labels_u8.cuda(), TrainConfig())
    torch.cuda.synchronize()
    launches = {"edge_weight_maps": K.edge_weight_maps.launches}
    say("main", f"predict_images over 4 scenes in {serve_s:.2f} s (first call); make_targets "
                f"{tuple(y_true.shape)}; kernel launches {launches}")
    check(launches["edge_weight_maps"] >= 1, "make_targets on the card did not launch the edge-weight kernel")
    check_results(imgs, results, pipe.ensemble.names)
    want = make_targets(labels_u8, TrainConfig())
    check(torch.equal(y_true.cpu(), want), "make_targets on the card differs from the CPU's")
    t0 = time.perf_counter()
    again = pipe.predict_images(imgs)
    torch.cuda.synchronize()
    say("main", f"second predict_images in {time.perf_counter() - t0:.2f} s; "
                f"timer {json.dumps(pipe.timer.summary())}")
    for a, b in zip(results, again):
        for name in a.masks:
            check((a.masks[name] == b.masks[name]).all(), f"{name}: two runs differ")
        check((a.fused == b.fused).all() and a.corners == b.corners, "two runs differ in fusion/polygons")
    say("main", "masks, fused masks and polygons well formed; two runs identical; blank degenerate scene")
    return launches


def phase_sweep(pipe):
    """tiles/s of the five-member forward (tiles -> packed argmax bits) per batch."""
    import torch

    ens = pipe.ensemble
    tile = pipe.cfg.tiler.tile
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    best = None
    for batch in SWEEP:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            tiles = torch.rand((batch, tile, tile, 3), generator=gen, device="cuda") * 2 - 1
            tiles = tiles.to(ens.compute_dtype)
            with torch.inference_mode():
                ms = cuda_ms(lambda: ens.member_bits(tiles), 3)
        except torch.cuda.OutOfMemoryError:
            say("sweep", f"batch_tiles={batch}: out of memory")
            continue
        finally:
            tiles = None
        rate = batch / (ms / 1000.0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        say("sweep", f"batch_tiles={batch}: {ms:.1f} ms per batch, {rate:.2f} tiles/s, peak {peak:.2f} GiB")
        best = max(best or (0.0, 0), (rate, batch))
    check(best is not None, "no batch size ran")
    say("sweep", f"fastest: batch_tiles={best[1]} at {best[0]:.2f} tiles/s")


def phase_serving(pipe):
    try:
        from PIL import Image
    except ImportError:
        say("serve", "PIL absent: DetectionService.handle_photo not exercised")
        return
    import io
    import tempfile

    import numpy as np

    from building_detection_tpu.serve.server import DetectionService

    rng = np.random.RandomState(SEED + 3)
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as root:
        service = DetectionService(pipe, pipe.cfg, root_dir=root)
        for i in range(3):
            buf = io.BytesIO()
            Image.fromarray(rng.randint(0, 256, (600, 800, 3)).astype(np.uint8)).save(buf, format="PNG")
            answer = service.handle_photo("smoke", f"scene{i}.png", buf.getvalue())
            check(answer["status"] == "success", f"/photo answered {answer['status']}: {answer['error']}")
        service.drain(timeout_s=60)
    say("serve", "DetectionService.handle_photo answered 3 PNG requests with status success")


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import torch

    from building_detection_tpu_torch.infer.pipeline import Pipeline

    t_start = time.perf_counter()
    kind, _ = phase_device()
    phase_build()
    edge = phase_edge_check()
    phase_normalize()
    phase_parity()
    pipe = Pipeline(device="cuda", compute_dtype=torch.bfloat16, seed=SEED)
    launches = phase_main_path(pipe)
    phase_serving(pipe)
    phase_sweep(pipe)
    say("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    kernels = [{
        "name": "edge_weight_maps",
        "route": "cuda",
        "source": "building_detection_tpu_torch/csrc/edge_weights.cu",
        "replaces": "building_detection_tpu/kernels/pallas_morphology.py:98",
        "launches": launches["edge_weight_maps"],
        **edge,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"[chip_smoke] FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
