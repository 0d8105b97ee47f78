#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``building_detection_tpu_torch``) on one CUDA card.

Usage, from the root of a checkout, with one card visible:

    python3 chip_smoke.py

It builds the port's hand-written kernel from ``building_detection_tpu_torch/csrc``
with ``nvcc``, checks it bit for bit against its plain PyTorch twin on the
card at every case of ``EDGE_CHECKS``, and drives the port's two paths at
full width, random weights from a seed, through the entry points on their
default device (the card):

* serving: the five-member ensemble through ``Pipeline().predict_images`` on
  512x512 tiles in bf16, the port's own ``DetectionService`` (fusion,
  polygons and geometry are the port's copies), and ``make_targets``;
* the per-model engine: ``Pipeline(fused=False)`` over the same scenes in
  bf16, and in f32 with TF32 off each member's mask equal to the fused
  path's on a 1024x1024 scene (one chunk of 9 tiles on both paths);
* blocked large scenes: a 4096x4096 scene through ``Pipeline(max_scene_tiles=64)``
  against the whole scene (time, peak device memory, differing pixels), and
  in f32 with TF32 off, deterministic cuDNN and one tile a forward, blocked
  equal to whole on a 2048x2048 scene for the ensemble and one member;
* inference over several devices in one process (``[tile_dp]``), on every
  card when more than one is visible, else on ``cuda:0`` twice: in f32 with
  TF32 off and deterministic cuDNN, ``FusedEnsemblePredictor(mesh=)`` and
  ``Pipeline(mesh=)`` equal to one device where every tile meets the same
  forward batch size, and ``EnsemblePredictor(devices=)`` equal to one
  device; bf16 tiles/s and peak memory per device on the mesh against one
  device (on 1, 2, 4 ... cards where there are several), the host's
  enqueue time of a sharded chunk, differing pixels (counted, not gated);
  and ``bdt-eval --data-parallel N --coordinator ...`` over N NCCL
  processes (N = the cards visible) equal to a one-process ``bdt-eval``;
* int8 pointwise convs: ``Pipeline(int8_pointwise=512, int8_calibration=...)``
  calibrated on the smoke scenes, ``predict_images`` through it (every active
  site through ``torch._int_mm``, counted), tiles/s and differing pixels
  against bf16; ``_int_mm`` bit-equal to its int32 twin at a real Xception
  site shape and timed against a bf16 ``torch.matmul`` of that shape;
* the CLIs as subprocesses: ``bdt-predict`` over a directory (one process,
  then two shards whose union equals it, file for file), ``bdt-serve`` on an
  ephemeral port (``/health``, three ``POST /photo`` sent with the port's
  ``bdt-client`` ``detect``, the client CLI once, SIGTERM drains and exits
  0) and ``bdt-augment`` (host only);
* Keras ``.h5`` with the port's own HDF5 reader and writer (no ``h5py``):
  the five members' weights written under the reference deployment's file
  names and read back bit for bit (MiB/s each way), one cut short refused
  as truncated, ``Pipeline`` over them equal to the ``.npz`` run (bf16
  masks), ``Trainer.load_weights`` of an ``.h5`` equal to that of its
  ``.npz``, ``bdt-convert`` both ways;
* training: ``Trainer`` steps for each of the five members on 512x512 tiles
  at batch 8, in f32 and bf16, with ``make_targets`` (and so the kernel)
  inside every step; one f32 step per member held against the same step on
  the CPU; save/restore and the staged epoch held against the per-step path;
  ``Trainer(remat=True)`` against ``remat=False`` (f32 bit-equal, bf16 peak
  memory and step time);
* data-parallel training (``parallel/``), each leg in child processes so
  this process never holds a process group: NCCL at world size 1 on the
  card (res34, 512x512, batch 8: f32 bit-equal to a plain ``Trainer``, bf16
  step time and peak memory beside a plain one's); two Gloo ranks sharing
  the card (f32, 4 rows a rank: losses within 2e-4 of one process on the
  same 8 samples, the ranks' params bit-identical, the kernel launched on
  each rank's (4, 512, 512) labels once a step); and ``bdt-train
  --coordinator ... --num-processes 1 --process-id 0`` on the card, whose
  checkpoint restores;
* every local card of each process (``[hybrid]``, ``parallel/launch.py``):
  res34 at 128x128, global batch 8, 2 f32 steps (TF32 off) through
  ``bdt-train``'s body in every worker, (a) two launcher processes of two
  workers against (b) one of four (loss rel 1e-5, checkpoint params atol
  1e-5; whether they are bit-equal is printed), then ``bdt-eval``'s body on
  (a)'s checkpoint in both layouts (the same metrics), then bf16 steps a
  rank against one card alone (step ms and peak memory, no gate).  On four
  cards or more it runs the shipped CLI over NCCL (``--local-devices 2
  --coordinator ...`` on cards 0,1 and 2,3; no process flags over four
  cards), each launcher a ``chip_smoke.py --hybrid-cli ARGS`` child whose
  workers run ``hybrid_body``; with fewer, the launcher's library form over
  Gloo workers sharing the cards (``--hybrid-lib``).  Every rank's place and
  card is printed, and the edge kernel is held bit-equal to its twin on
  every rank's (2, 128, 128) labels at each call;
* the per-model predictor over a mesh that spans processes
  (``[tile_procs]``): v3plus at full width through ``TiledPredictor`` on
  the shipped tiler (512x512 tiles) over a 1024x1024 and a 700x1300 scene,
  in launched workers (``parallel/launch.py``, each launcher a
  ``chip_smoke.py --tile-procs SPEC`` child): on one card two Gloo workers
  sharing it at ``data=2`` and at ``data=1 x model=2, tp=True``; on four
  cards or more two launchers of two NCCL workers (cards 0,1 and 2,3) at
  ``data=4``, ``2 x 2`` and ``1 x 4`` with ``tp=True``.  In f32 with TF32
  off and deterministic cuDNN: tile data parallelism bit-equal to the
  one-process predictor at the same per-tile forward batch, TP within
  0.01 % of its pixels, and every rank's masks bit-equal to rank 0's; in
  bf16 tiles/s and peak memory a rank against one process on one card (no
  gate);
* channel tensor parallelism (``[tp]``, ``parallel/tp.py``): v3plus, whose
  728-channel Xception middle flow has the widest sharded convs, through
  ``TiledPredictor(tp=True)`` on ``cuda:0`` twice (``data=1 x model=2``;
  on four cards also ``model=4`` and ``data=2 x model=2``) against one
  device on a 1024x1024 scene, in f32 with TF32 off and deterministic
  cuDNN (at most 0.01 % of the pixels and 1e-4 of the softmax apart), and
  in bf16 (tiles/s, peak memory a device, the host's enqueue time); then
  scse at 512x512, batch 8, through ``Trainer(tp=True)`` over two Gloo ranks
  sharing the card (``data=1 x model=2``; on four cards also NCCL at ``2 x
  2`` and ``1 x 4``), each rank a child process: one f32 step against one
  process (loss rel 2e-4, params rtol 1e-3 / atol 1e-4, and the Adam
  moments, which carry the gradients that a first step at the warmup lr
  cannot show in the params, within 1e-3 of each tensor's largest), the checkpoint
  gathered from the slices, the edge kernel bit-equal to its twin on every
  rank's labels and launched once a step there, bf16 step time and peak
  memory a rank, and the collectives a step;
* ``[morph]``: ``majority_vote`` over five 4096x4096 masks and
  ``fill_holes`` on a 1024x1024 mask with holes on the card, bit-equal to
  the CPU, with their times and ``fill_holes``' grow steps.
* ``[learn]``: each of the five members learns, in a process of its own,
  the five side by side (``chip_smoke.py --learn-child NAME``), by the JAX
  package's learning-smoke recipe (``train/learn_smoke.py``: synthetic rectangles,
  300 bf16 steps at 128x128 for res34, scse and hrnet, 150 for v3plus and
  bam, staged chunks of 50, warmup-cosine from lr 5e-4; seed 0), to a
  held-out IoU above 0.5 with the eval-mode model, and each line gives
  the held-out IoU with the batch's own BN statistics beside it (the
  moving statistics' lag is the difference); then one step of each member
  at that size are profiled under ``utils/profiling.py::device_trace``:
  device ops and device milliseconds a step, and the busy share against
  the unprofiled step's CUDA-event time.

It imports nothing of JAX and nothing of the JAX package.  Any failed check
exits non-zero before the result lines.  The second-to-last line is a JSON
object with each kernel's launches on the two paths, its error against the
twin, its time, the twin's, its bound and share of it; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import copy
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time

SEED = 0
SWEEP = (8, 32, 64)               # batch_tiles values timed on the ensemble forward
PARITY_ATOL = 1e-3                # f32 card vs CPU, ~100 layers summed in other orders
EDGE_SHAPE = (8, 512, 512)        # the trainer's label batch
# (shape, kernel, iterations, weight, storage offset in floats) the kernel is
# held bit-equal to its twin at: the trainer's batch; odd sizes with two
# odd windows; an even window; W not a multiple of 4; rows wider than one
# 512-column chunk (aligned, and ragged); a base pointer off 16 bytes; the
# smallest and largest windows; a strip taller than the image; a rank's
# half of the trainer's batch under two-way data parallelism; the [learn]
# recipe's batch at 128x128.
EDGE_CHECKS = (
    (EDGE_SHAPE, 3, 5, 2.0, 0),
    ((3, 77, 131), 2, 4, 3.0, 0),
    ((3, 77, 131), 5, 2, 1.5, 0),
    ((2, 64, 96), 2, 3, 2.0, 0),
    ((2, 40, 1100), 3, 5, 2.0, 0),
    ((1, 37, 1030), 4, 3, 2.0, 0),
    ((2, 64, 96), 3, 5, 2.0, 1),
    ((2, 30, 50), 1, 1, 2.0, 0),
    ((2, 70, 600), 3, 16, 2.0, 0),
    ((2, 5, 40), 3, 5, 2.0, 0),
    ((4, 512, 512), 3, 5, 2.0, 0),
    ((8, 128, 128), 3, 5, 2.0, 0),
)
HBM_BYTES_PER_S = 3.35e12         # H100 SXM device memory, NVIDIA's data sheet
F32_OPS_PER_S = 67e12             # H100 SXM f32 outside the tensor cores, same source
TRAIN_STEPS = 3                   # full-width steps per member and dtype, on one fixed batch
TRAIN_PARITY_PX = 64              # the card-vs-CPU train step: 64 px, batch 2
# Tolerances of that step, card vs CPU, f32 with TF32 off.  The loss is one
# forward, summed in other orders.  Params: the step runs at the warmup lr
# 1e-5, and Keras Adam moves a weight by at most about lr whatever its
# gradient, so even a gradient of opposite sign moves it < 3e-5 apart.  BN
# moving statistics after one step: 0.01 x the batch statistics of identical
# weights, relative to the largest.
TRAIN_LOSS_ATOL = 1e-4
TRAIN_PARAM_ATOL = 3e-5
TRAIN_STATE_RTOL, TRAIN_STATE_ATOL = 1e-4, 1e-5
BIG_SCENE = 4096                  # 11 x 11 = 121 tiles: blocked at max_scene_tiles=64
EXACT_SCENE = 2048                # 6 x 6 = 36 tiles, blocks of 9: blocked == whole in f32
CLI_SCENES = {"a": (1024, 1024), "b": (1024, 1024), "h": (700, 1300), "x": (100, 100)}
CLI_TIMEOUT_S = 600
INT8_SITE = (32 * 32 * 32, 728, 728)  # M, K, N: batch 32 at 32x32 x 728->728, an Xception middle-flow projection
INT8_MIN_CH = 512                 # the CLIs' int8_pointwise: the Xception projections only
REMAT_MEMBER = "res34"            # the member of the remat phase, 512x512, batch 8
REMAT_STEPS = 3                   # bf16 steps each way (median of the last two)
DP_MEMBER = "res34"               # the member of the data-parallel phase, 512x512, global batch 8
DP_STEPS = 4                      # bf16 steps each way under NCCL: 1 warm-up, then 3 timed
DP_GLOO_STEPS = 2                 # f32 steps of the two Gloo ranks sharing the card
DP_LOSS_RTOL = 2e-4               # two ranks vs one process: the JAX package's DP tolerance
DP_TIMEOUT_S = 600
TILE_DP_SCENES = ((1024, 1024), (700, 1300))  # 9 and 8 tiles: 9 divides by no shard count above 1
TILE_DP_RATE_SCENES = 12          # 1024^2 scenes timed in bf16: groups of 3, 6, 12 scenes on 1, 2, 4 shards, 27-tile forwards
TILE_DP_BATCHES = (4, 2, 1)       # per-shard batch_tiles tried for the f32 check, largest first
EVAL_RESULT = "eval launches "
ENQUEUE_REPEATS = 7               # one-tile-a-shard sharded_bits calls timed on the host clock, their median
H5_PROBE_REPEATS = 5              # imports of the five members' .h5 timed by --h5-probe
TP_INFER_MEMBER = "v3plus"        # the [tp] inference member: the 728-channel Xception middle flow, the widest sharded convs
TP_TRAIN_MEMBER = "scse"          # the [tp] training member, 512x512, batch 8: the fewest bytes gathered a step
TP_SCENE = 1024                   # 3 x 3 = 9 tiles
TP_PIXEL_FRAC = 1e-4              # f32 TP vs one device: at most 0.01 % of the pixels differ (cuDNN picks by shape)
TP_PROB_ATOL = 1e-4               # ... and the softmax by at most this
TP_RATE_SCENES = 8                # 1024^2 scenes timed in bf16, TP against one device
TP_STEPS = 2                      # bf16 TP steps a leg: 1 warm-up, then 1 timed
TP_PARAM_RTOL, TP_PARAM_ATOL = 1e-3, 1e-4  # TP vs one process after one f32 step: the JAX package's TP tolerances
TP_MOMENT_RTOL, TP_MOMENT_FLOOR = 1e-3, 1e-5  # its Adam moments: of a tensor's largest, plus of the largest of any
TP_TIMEOUT_S = 600
TP_RESULT = "tp result "
MORPH_VOTE = (5, 4096, 4096)      # majority_vote: five 4096^2 masks
MORPH_FILL = 1024                 # fill_holes: a 1024^2 mask with holes
LEARN_WARMUP_STEPS = 1            # [learn] profile: bf16 steps at the recipe's 128^2 before the timed ones
LEARN_PROFILE_STEPS = 1           # ... steps timed by CUDA events, then as many under device_trace
LEARN_TIMEOUT_S = 900             # the five [learn] members' processes, side by side
LEARN_RESULT = "learn result "
HYBRID_MEMBER = "res34"           # the [hybrid] member: its BN statistics reduce over every rank
HYBRID_PX = 128                   # [hybrid]: 16 samples of 128^2, global batch 8, 2 f32 steps through bdt-train
HYBRID_SAMPLES = 16
HYBRID_BF16_STEPS = 2             # bf16 steps a rank after the CLI legs: 1 warm-up, then 1 timed
TILE_PROCS_RATE_SCENES = 2        # [tile_procs]: 1024^2 scenes timed in bf16 a layout, after one warm-up scene
TILE_PROCS_TIMEOUT_S = 300
TILE_PROCS_RESULT = "tile_procs result "
HYBRID_LOSS_RTOL = 1e-5           # (a) two processes x 2 against (b) one process x 4
HYBRID_PARAM_ATOL = 1e-5
HYBRID_TIMEOUT_S = 300
# the [h5] phase's files: the reference deployment's names (infer/pipeline.py::discover_weights)
H5_FILES = {"res34": "resnet34.h5", "hrnet": "hrnet.h5", "v3plus": "deep.h5", "scse": "scse.h5", "bam": "bam.h5"}


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
    from building_detection_tpu_torch.post import geometry

    say("device", "native geometry library " + ("loaded" if geometry.native() is not None else "absent: numpy path"))
    return name, smi_line


def phase_build():
    from building_detection_tpu_torch.kernels import edge_weights as K

    t0 = time.perf_counter()
    K.load_library()
    say("build", f"edge_weights.cu built and loaded in {time.perf_counter() - t0:.1f} s")


def edge_label(shape, seed: int, offset: int = 0):
    """A seeded {0,1} label on the card; ``offset`` floats into its storage."""
    import torch

    lab = torch.from_numpy(labels_np(seed, shape))
    buf = torch.empty(offset + lab.numel(), dtype=torch.float32, device="cuda")
    out = buf[offset:].view(shape)
    out.copy_(lab)
    return out


def edge_bound_ms(shape, kernel: int, iterations: int) -> "tuple[float, str]":
    """The least time of one call: 4 bytes read and 8 written per pixel over
    the memory rate, or two separable passes of (win - 1) min and max taps
    plus the two subtractions and compares per pixel over the f32 rate."""
    px = math.prod(shape)
    win = iterations * (kernel - 1) + 1
    by_bytes = 12 * px / HBM_BYTES_PER_S * 1e3
    by_ops = px * (4 * (win - 1) + 4) / F32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def device_us(fn, flush, runs: int = 10):
    """Mean device time in microseconds of the edge-weight kernel over
    ``runs`` calls of ``fn`` (``flush()`` before each), from torch.profiler's
    kernel records; None where the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            flush()
            fn()
        torch.cuda.synchronize()
    for event in prof.key_averages():
        if "edge_weight_kernel" in event.key:
            total = getattr(event, "device_time_total", None) or getattr(event, "cuda_time_total", 0.0)
            return total / max(event.count, 1) if total else None
    return None


def phase_edge_check():
    """Kernel vs plain twin on the card at every EDGE_CHECKS case (bit for
    bit), and both times at the trainer's shape.  Beside them, what the
    kernel's reading is made of: the method's floor (a one-element kernel
    timed the same way), the reading with L2 flushed by a read (clean
    lines) instead of a write (dirty lines), the kernel's own device time
    from torch.profiler, and the time per call back to back with L2 warm."""
    import torch

    from building_detection_tpu_torch.kernels import edge_weights as K

    err = 0.0
    for i, (shape, kernel, iters, weight, offset) in enumerate(EDGE_CHECKS):
        lab = edge_label(shape, SEED + i, offset)
        got = K.edge_weight_maps(lab, kernel, iters, weight)
        want = K.edge_weight_maps_plain(lab, kernel, iters, weight)
        torch.cuda.synchronize()
        err = max([err] + [float((g - w).abs().max()) for g, w in zip(got, want)])
        for g, w in zip(got, want):
            check(torch.equal(g, w), f"kernel differs from its twin at {shape} kernel={kernel} x{iters} "
                                     f"weight={weight} offset={offset}")
    say("edge", f"kernel bit-equal to its plain twin at all {len(EDGE_CHECKS)} cases "
                f"(shapes, windows 1-33 odd and even, ragged and misaligned rows)")
    lab = edge_label(EDGE_SHAPE, SEED)
    scratch = torch.empty(64 << 20, dtype=torch.float32, device="cuda")  # 256 MB > L2
    flush = scratch.zero_
    ms = cuda_ms(lambda: K.edge_weight_maps(lab), 30, flush)
    plain_ms = cuda_ms(lambda: K.edge_weight_maps_plain(lab), 30, flush)
    bound_ms, bound_by = edge_bound_ms(EDGE_SHAPE, 3, 5)
    say("edge", f"at {EDGE_SHAPE}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 30, L2 flushed by a "
                f"256 MB write before each); bound {bound_ms:.4f} ms by {bound_by}, {100 * bound_ms / ms:.1f} % of it")
    one = torch.zeros(1, device="cuda")
    sink = torch.empty((), dtype=torch.float32, device="cuda")
    floor_ms = cuda_ms(lambda: one.add_(1.0), 30, flush)
    read_ms = cuda_ms(lambda: K.edge_weight_maps(lab), 30, lambda: torch.sum(scratch, 0, out=sink))
    dev_us = device_us(lambda: K.edge_weight_maps(lab), flush)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(100):
        K.edge_weight_maps(lab)
    end.record()
    end.synchronize()
    say("edge", f"floor of the method (one-element kernel, same flush) {floor_ms:.4f} ms; kernel with L2 flushed by a "
                f"read {read_ms:.4f} ms; device time (torch.profiler, mean of 10) "
                f"{'not seen' if dev_us is None else f'{dev_us:.2f} us'}; back to back, L2 warm "
                f"{start.elapsed_time(end) / 100:.4f} ms a call")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "pct_of_bound": 100 * bound_ms / ms, "library_ms": None}


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

    saved = exact_f32()
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
        restore_backends(saved)


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
    """The counted serving run: the port's entry points, once each, on the card."""
    import torch

    from building_detection_tpu_torch.core.config import TrainConfig
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

    from building_detection_tpu_torch.serve.server import DetectionService

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


def exact_f32():
    """f32 with TF32 off and deterministic cuDNN: equal inputs at equal batch
    shapes give equal outputs.  Returns the settings to restore."""
    import torch

    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    return saved


def restore_backends(saved) -> None:
    import torch

    (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) = saved


def seeded_members(seed: int):
    """The five members with the Pipeline's seeded random weights."""
    import torch

    from building_detection_tpu_torch.models.registry import ENSEMBLE_ORDER, init_model

    return {name: init_model(name, torch.Generator().manual_seed(seed + i)) for i, name in enumerate(ENSEMBLE_ORDER)}


def timed(fn):
    """(result, seconds) of ``fn()``, the card synchronized on both sides."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def scene_tiles(imgs, cfg) -> int:
    from building_detection_tpu_torch.ops import tiling as T

    return sum(T.plan_tiles(*img.shape[:2], cfg).num_tiles for img in imgs)


def phase_engine(pipe):
    """The per-model engine on its entry point, ``Pipeline(fused=False)``, bf16
    on the card: the four scenes well formed and identical over two runs;
    both paths' device seconds and tiles/s on those scenes.  Then f32 with
    TF32 off: each member's mask equal to the fused path's on one 1024x1024
    scene, 9 tiles, one chunk of the same tiles on both paths."""
    import numpy as np
    import torch

    from building_detection_tpu_torch.core.config import TilerConfig
    from building_detection_tpu_torch.infer.engine import EnsemblePredictor
    from building_detection_tpu_torch.infer.fused_ensemble import DEFAULT_BATCH_TILES, FusedEnsemblePredictor
    from building_detection_tpu_torch.infer.pipeline import Pipeline

    imgs = scenes()
    engine = Pipeline(compute_dtype=torch.bfloat16, seed=SEED, fused=False)
    check(isinstance(engine.ensemble, EnsemblePredictor), "Pipeline(fused=False) did not build the engine")
    check(all(p.device.type == "cuda" for p in engine.ensemble.predictors.values()),
          "the engine's members are not on the card")
    first, first_s = timed(lambda: engine.predict_images(imgs))
    again, again_s = timed(lambda: engine.predict_images(imgs))
    check_results(imgs, first, engine.ensemble.names)
    for a, b in zip(first, again):
        for name in a.masks:
            check((a.masks[name] == b.masks[name]).all(), f"engine {name}: two runs differ")
        check((a.fused == b.fused).all() and a.corners == b.corners, "engine: two runs differ in fusion/polygons")
    tiles = scene_tiles(imgs, engine.cfg.tiler)
    _, engine_s = timed(lambda: [engine.ensemble.predict_masks(img) for img in imgs])
    fused_masks, fused_s = timed(lambda: pipe.ensemble.predict_masks_many(imgs))
    diff = {name: sum(int((r.masks[name] != f[name]).sum()) for r, f in zip(first, fused_masks))
            for name in engine.ensemble.names}
    say("engine", f"Pipeline(fused=False).predict_images over 4 scenes: {first_s:.2f} s first call, {again_s:.2f} s "
                  f"second; two runs identical, well formed, blank degenerate scene")
    say("engine", f"device path over the 4 scenes ({tiles} tiles, bf16): engine {engine_s:.3f} s = "
                  f"{tiles / engine_s:.2f} tiles/s, fused {fused_s:.3f} s = {tiles / fused_s:.2f} tiles/s; "
                  f"pixels differing engine vs fused (bf16, other batch shapes) {json.dumps(diff)}")
    del engine, first, again, fused_masks
    torch.cuda.empty_cache()

    saved = exact_f32()
    try:
        (img,) = [np.random.RandomState(SEED + 7).randint(0, 256, (1024, 1024, 3)).astype(np.uint8)]
        fused = FusedEnsemblePredictor(seeded_members(SEED), TilerConfig(), DEFAULT_BATCH_TILES, torch.float32)
        per_model = EnsemblePredictor(seeded_members(SEED), TilerConfig(), DEFAULT_BATCH_TILES, torch.float32)
        want = fused.predict_masks(img)
        got = per_model.predict_masks(img)
        for name in fused.names:
            check(np.array_equal(got[name], want[name]),
                  f"f32 engine {name}: {int((got[name] != want[name]).sum())} pixels differ from the fused path")
        say("engine", f"f32, TF32 off: per-member masks of the engine equal the fused path's on a 1024x1024 scene "
                      f"(9 tiles, one chunk on both paths); class-1 share "
                      f"{json.dumps({n: round(float((got[n] > 0).mean()), 4) for n in fused.names})}")
    finally:
        restore_backends(saved)
    del fused, per_model
    torch.cuda.empty_cache()


def phase_blocked(pipe):
    """A BIG_SCENE^2 scene (121 tiles) through ``Pipeline(max_scene_tiles=64)``,
    so through the blocked path, against the same scene whole through
    ``pipe`` (same seeded weights): time, peak device memory, differing
    pixels per member; the blocked run twice, identical.  Then f32 exact:
    blocked == whole with one tile a forward on an EXACT_SCENE^2 scene."""
    import numpy as np
    import torch

    from building_detection_tpu_torch.core.config import TilerConfig
    from building_detection_tpu_torch.infer import large_scene as LS
    from building_detection_tpu_torch.infer.engine import TiledPredictor
    from building_detection_tpu_torch.infer.fused_ensemble import FusedEnsemblePredictor
    from building_detection_tpu_torch.infer.pipeline import Pipeline
    from building_detection_tpu_torch.models.registry import init_model

    big = np.random.RandomState(SEED + 8).randint(0, 256, (BIG_SCENE, BIG_SCENE, 3)).astype(np.uint8)
    blocked = Pipeline(compute_dtype=torch.bfloat16, seed=SEED, max_scene_tiles=64)
    check(blocked._needs_blocking(big) and not pipe._needs_blocking(big), "the big scene is not routed as planned")
    n_blocks = len(LS.plan_blocks(BIG_SCENE, BIG_SCENE, blocked.cfg.tiler, blocked.batch_tiles))
    runs = {}
    for label, p in (("blocked", blocked), ("whole", pipe), ("blocked again", blocked)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        p.timer.reset()
        (res,), secs = timed(lambda: p.predict_images([big]))
        peak = torch.cuda.max_memory_allocated()
        runs[label] = res
        for m in list(res.masks.values()) + [res.fused]:
            check(m.shape == big.shape[:2] and set(np.unique(m).tolist()) <= {0, 255}, f"{label}: mask malformed")
        stages = {k: round(v["seconds"], 3) for k, v in p.timer.summary().items()}
        say("blocked", f"{label}: {BIG_SCENE}x{BIG_SCENE} scene in {secs:.2f} s (stages {json.dumps(stages)}); peak "
                       f"device memory {peak / 2**30:.3f} GiB, {(peak - base) / 2**30:.3f} GiB above the "
                       f"{base / 2**30:.3f} GiB held before the call"
                       + (f"; {n_blocks} blocks of <= {blocked.batch_tiles} tiles" if label == "blocked" else ""))
    a, b, whole = runs["blocked"], runs["blocked again"], runs["whole"]
    for name in a.masks:
        check((a.masks[name] == b.masks[name]).all(), f"blocked {name}: two runs differ")
    check((a.fused == b.fused).all() and a.corners == b.corners, "blocked: two runs differ in fusion/polygons")
    diff = {name: int((a.masks[name] != whole.masks[name]).sum()) for name in a.masks}
    say("blocked", f"bf16 pixels differing blocked vs whole (of {BIG_SCENE * BIG_SCENE} per member): "
                   f"{json.dumps(diff)}; fused mask {int((a.fused != whole.fused).sum())}")
    del blocked, runs, a, b, whole
    torch.cuda.empty_cache()

    img = np.random.RandomState(SEED + 9).randint(0, 256, (EXACT_SCENE, EXACT_SCENE, 3)).astype(np.uint8)
    saved = exact_f32()
    try:
        fused = FusedEnsemblePredictor(seeded_members(SEED), TilerConfig(), 1, torch.float32)
        want = fused.predict_masks(img)
        got = LS.predict_masks_blocked(fused, img, max_block_tiles=9)
        for name in fused.names:
            check(np.array_equal(got[name], want[name]),
                  f"f32 blocked {name}: {int((got[name] != want[name]).sum())} pixels differ from the whole scene")
        one = TiledPredictor(init_model("res34", torch.Generator().manual_seed(SEED)), TilerConfig(), 1, torch.float32)
        check(np.array_equal(LS.predict_mask_blocked(one, img, max_block_tiles=9), one.predict_mask(img)),
              "f32 blocked res34 (TiledPredictor) differs from its whole-scene mask")
        say("blocked", f"f32, TF32 off, deterministic, batch_tiles=1: {EXACT_SCENE}x{EXACT_SCENE} scene (36 tiles, "
                       f"blocks of 9): predict_masks_blocked == predict_masks for all 5 members, "
                       f"predict_mask_blocked == predict_mask for res34")
    finally:
        restore_backends(saved)
    del fused, one
    torch.cuda.empty_cache()


def tile_batches(tiles: int, batch: int, shards: int) -> list:
    """The forward batch size each tile of a one-scene dispatch meets in the
    fused predictor: chunks of ``batch * shards`` tiles, each split into
    ``shards`` equal parts after padding to a multiple of ``shards``."""
    out = []
    for start in range(0, tiles, batch * shards):
        m = min(batch * shards, tiles - start)
        out += [-(-m // shards)] * m
    return out


def sync_all(devices) -> None:
    import torch

    for d in dict.fromkeys(devices):
        torch.cuda.synchronize(d)


def phase_tile_dp(pipe, here: str, smi: str) -> int:
    """Inference over several devices in one process, then ``bdt-eval`` over
    NCCL processes (see the module docstring).  Returns the edge-kernel
    launches of the ``bdt-eval`` processes' ``make_targets``."""
    import numpy as np
    import torch

    from building_detection_tpu_torch.core.config import TilerConfig
    from building_detection_tpu_torch.infer.engine import EnsemblePredictor
    from building_detection_tpu_torch.infer.fused_ensemble import DEFAULT_BATCH_TILES, FusedEnsemblePredictor
    from building_detection_tpu_torch.infer.pipeline import Pipeline
    from building_detection_tpu_torch.ops import tiling as T
    from building_detection_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    n_cards = torch.cuda.device_count()
    devices = [f"cuda:{i}" for i in range(n_cards)] if n_cards > 1 else ["cuda:0", "cuda:0"]
    k = len(devices)
    mesh = make_mesh(devices=devices)
    say("tile_dp", f"mesh over {devices}: " + ("every visible card" if n_cards > 1 else "cuda:0 twice, one card visible"))
    rng = np.random.RandomState(SEED + 40)
    imgs = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for h, w in TILE_DP_SCENES]
    counts = [T.plan_tiles(*img.shape[:2], TilerConfig()).num_tiles for img in imgs]
    base = seeded_members(SEED)

    saved = exact_f32()
    try:
        batch = next(b for b in TILE_DP_BATCHES if all(tile_batches(n, b, 1) == tile_batches(n, b, k) for n in counts))
        one = FusedEnsemblePredictor(copy.deepcopy(base), TilerConfig(), batch, torch.float32)
        meshed = FusedEnsemblePredictor(copy.deepcopy(base), TilerConfig(), batch, torch.float32, mesh=mesh)
        check(meshed.batch_tiles == batch * k and list(meshed.replicas) == list(dict.fromkeys(meshed.devices)),
              f"the mesh predictor holds {meshed.batch_tiles} tiles a chunk on {list(meshed.replicas)}")
        for img in imgs:
            want, got = one.predict_masks(img), meshed.predict_masks(img)
            for name in one.names:
                check(np.array_equal(got[name], want[name]),
                      f"f32 mesh {name}: {int((got[name] != want[name]).sum())} pixels differ from one device on a "
                      f"{img.shape[0]}x{img.shape[1]} scene")
        del meshed, one
        torch.cuda.empty_cache()
        ens_one = EnsemblePredictor(copy.deepcopy(base), TilerConfig(), DEFAULT_BATCH_TILES, torch.float32)
        ens_dev = EnsemblePredictor(copy.deepcopy(base), TilerConfig(), DEFAULT_BATCH_TILES, torch.float32,
                                    devices=devices)
        placed = [str(p.device) for p in ens_dev.predictors.values()]
        want, got = ens_one.predict_masks(imgs[0]), ens_dev.predict_masks(imgs[0])
        for name in ens_one.names:
            check(np.array_equal(got[name], want[name]),
                  f"f32 EnsemblePredictor(devices=) {name}: {int((got[name] != want[name]).sum())} pixels differ")
        del ens_one, ens_dev
        say("tile_dp", f"f32, TF32 off, deterministic cuDNN, scenes of {counts} tiles: FusedEnsemblePredictor(mesh=) "
                       f"at batch_tiles={batch} a shard equals one device at batch_tiles={batch} (forward batch per "
                       f"tile {[tile_batches(n, batch, k) for n in counts]} on both); on the {counts[0]}-tile scene "
                       f"EnsemblePredictor(devices=) with members on {placed} equals one device")
    finally:
        restore_backends(saved)
    torch.cuda.empty_cache()

    # bf16 through the entry point, then tiles/s: one device against meshes of 2, 4 ... cards (or cuda:0 twice)
    piped = Pipeline(compute_dtype=torch.bfloat16, seed=SEED, mesh=mesh)
    check(piped.ensemble.devices == mesh.devices and piped.ensemble.batch_tiles == DEFAULT_BATCH_TILES * k,
          f"Pipeline(mesh=) built {piped.ensemble.devices}, {piped.ensemble.batch_tiles} tiles a chunk")
    smoke = scenes()
    check_results(smoke, piped.predict_images(smoke), piped.ensemble.names)
    say("tile_dp", "bf16 Pipeline(mesh=).predict_images over the 4 smoke scenes: well formed, blank degenerate scene")
    runs = {"one device": pipe.ensemble}
    for m in (2, 4):
        if m < n_cards:
            runs[f"cuda:0..{m - 1}"] = FusedEnsemblePredictor(
                copy.deepcopy(base), TilerConfig(), DEFAULT_BATCH_TILES, torch.bfloat16,
                mesh=make_mesh(devices=[f"cuda:{i}" for i in range(m)]))
    runs[",".join(devices) if n_cards == 1 else f"cuda:0..{n_cards - 1}"] = piped.ensemble
    del base
    scenes_bf16 = [rng.randint(0, 256, (1024, 1024, 3)).astype(np.uint8) for _ in range(TILE_DP_RATE_SCENES)]
    tiles = 9 * TILE_DP_RATE_SCENES
    order = list(runs)
    masks, rates = {}, {}
    for label in order:  # warm-up: first launches and cuDNN's choices for the 27-tile forward
        runs[label].predict_masks_many(scenes_bf16[: 3 * len(runs[label].devices)])
    for label in order + order[::-1]:
        ens = runs[label]
        sync_all(ens.devices)
        for d in dict.fromkeys(ens.devices):
            torch.cuda.reset_peak_memory_stats(d)
        start = time.perf_counter()
        out = ens.predict_masks_many(scenes_bf16)
        secs = time.perf_counter() - start  # the fetch of the last bitplanes waited for every shard
        masks.setdefault(label, out)
        peaks = {str(d): round(torch.cuda.max_memory_allocated(d) / 2**30, 3) for d in dict.fromkeys(ens.devices)}
        rates.setdefault(label, []).append(f"{tiles / secs:.2f} tiles/s, peak {json.dumps(peaks)} GiB")
    for label in order:
        diff = {n: sum(int((a[n] != b[n]).sum()) for a, b in zip(masks[label], masks["one device"]))
                for n in pipe.ensemble.names}
        say("tile_dp", f"bf16 {label}: {tiles} tiles in {TILE_DP_RATE_SCENES} 1024x1024 scenes, 27-tile forwards, "
                       f"batch_tiles={DEFAULT_BATCH_TILES} a shard: {'; '.join(rates[label])} (in turns "
                       f"{order + order[::-1]} after a warm-up; host clock); pixels differing from one device "
                       f"{json.dumps(diff)} ({smi})")
    widest = piped.ensemble
    for per_shard in (1, 27):
        enqueued, done = host_enqueue_ms(widest, per_shard, ENQUEUE_REPEATS if per_shard == 1 else 1)
        say("tile_dp", f"bf16 chunk of {per_shard} tile(s) a shard over {devices} (sharded_bits): the host "
                       f"returned from enqueuing the five members on every shard after {enqueued:.1f} ms, the bits "
                       f"were back after {done:.1f} ms (median of {ENQUEUE_REPEATS if per_shard == 1 else 1}) ({smi})")
    del runs, piped, widest, masks
    torch.cuda.empty_cache()

    eval_launches = tile_dp_eval(here, smi)
    say("tile_dp", f"phase {time.perf_counter() - t0:.1f} s")
    return eval_launches


def host_enqueue_ms(ens, per_shard: int, repeats: int) -> tuple:
    """``(enqueued, done)`` ms, the medians of ``repeats`` calls of
    ``ens.sharded_bits`` on ``per_shard`` random bf16 tiles a shard after a
    warm-up call: the host's return from enqueuing the five members on
    every shard, and the bits back on the host."""
    import numpy as np
    import torch

    chunk = (torch.rand((per_shard * len(ens.devices), 512, 512, 3), device=ens.device) * 2 - 1).to(torch.bfloat16)
    enqueued, done = [], []
    with torch.inference_mode():
        ens.sharded_bits(chunk)
        for _ in range(repeats):
            sync_all(ens.devices)
            start = time.perf_counter()
            bits = ens.sharded_bits(chunk)
            enqueued.append(time.perf_counter() - start)
            bits.cpu()
            done.append(time.perf_counter() - start)
    return float(np.median(enqueued)) * 1e3, float(np.median(done)) * 1e3


def enqueue_probe() -> int:
    """``chip_smoke.py --enqueue-probe``: the ``[tile_dp]`` host enqueue of
    one bf16 tile a shard (``host_enqueue_ms``, median of
    ``ENQUEUE_REPEATS``) on one device and on ``cuda:0`` twice, for the
    port found first on ``sys.path`` (the current directory's, so the same
    measurement runs against another checkout).  Prints one JSON line."""
    import torch

    from building_detection_tpu_torch.core.config import TilerConfig
    from building_detection_tpu_torch.infer.fused_ensemble import DEFAULT_BATCH_TILES, FusedEnsemblePredictor
    from building_detection_tpu_torch.parallel.mesh import make_mesh

    check(torch.cuda.is_available(), "no CUDA device")
    out = {}
    for label, mesh in (("one device", None), ("cuda:0 twice", make_mesh(devices=["cuda:0", "cuda:0"]))):
        ens = FusedEnsemblePredictor(seeded_members(SEED), TilerConfig(), DEFAULT_BATCH_TILES, torch.bfloat16,
                                     device=None if mesh else "cuda", mesh=mesh)
        out[label] = host_enqueue_ms(ens, 1, ENQUEUE_REPEATS)
        del ens
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    port = os.path.dirname(sys.modules["building_detection_tpu_torch"].__file__)
    print("enqueue probe " + json.dumps({"port": port, "ms": out, "smi": smi}), flush=True)
    return 0


def exact_eval_child(argv) -> int:
    """``chip_smoke.py --exact-eval ARGS``: ``bdt-eval ARGS`` in f32 with TF32
    off and deterministic cuDNN, then its edge-kernel launches on a line of
    their own."""
    from building_detection_tpu_torch.cli import evaluate
    from building_detection_tpu_torch.kernels import edge_weights as K

    exact_f32()
    K.edge_weight_maps.launches = 0
    rc = evaluate.main(argv)
    print(EVAL_RESULT + json.dumps({"launches": K.edge_weight_maps.launches}), flush=True)
    return rc


def tile_dp_eval(here: str, smi: str) -> int:
    """``bdt-eval res34 --data-parallel N --coordinator ... --num-processes N``
    over N NCCL processes, N the cards visible, against one ``bdt-eval``
    process on the same checkpoint and images: the metrics equal, the loss
    within 1e-6 relative, one JSON line from rank 0.  Returns the
    processes' edge-kernel launches."""
    import tempfile

    import torch
    from PIL import Image

    from building_detection_tpu_torch.core.config import TrainConfig
    from building_detection_tpu_torch.parallel import dryrun
    from building_detection_tpu_torch.train.trainer import Trainer

    n = torch.cuda.device_count()
    me = os.path.abspath(__file__)
    with tempfile.TemporaryDirectory(dir=here) as work:
        for sub in ("img", "lab"):
            os.makedirs(os.path.join(work, sub))
        for i in range(8):
            img, lab = train_batch(SEED + 50 + i, 1, 64)
            Image.fromarray(img[0]).save(os.path.join(work, "img", f"{i}.png"))
            Image.fromarray(lab[0]).save(os.path.join(work, "lab", f"{i}.png"))
        tr = Trainer(DP_MEMBER, TrainConfig(batch_size=8, image_size=64, warmup_epochs=0), seed=SEED)
        tr.train_on_batch(*train_batch(SEED + 60, 8, 64))  # moving BN statistics away from their start
        ckpt = os.path.join(work, "ck.npz")
        tr.save(ckpt)
        del tr
        torch.cuda.empty_cache()
        args = [DP_MEMBER, "--checkpoint", ckpt, "--images", os.path.join(work, "img"), "--labels",
                os.path.join(work, "lab"), "--batch-size", "8", "--image-size", "64", "--precision", "f32"]
        env = port_env(here)
        port = dryrun.free_port()
        start = time.perf_counter()
        *ranks, alone = dryrun.run_processes([
            [sys.executable, me, "--exact-eval", *args, "--data-parallel", str(n), "--coordinator",
             f"127.0.0.1:{port}", "--num-processes", str(n), "--process-id", str(r)] for r in range(n)
        ] + [[sys.executable, me, "--exact-eval", *args, "--local-devices", "1"]], env, DP_TIMEOUT_S, cwd=here)
        multi_s = time.perf_counter() - start

    def parse(run, what):
        rc, out = run
        check(rc == 0, f"{what} exited {rc}: {out[-4000:]}")
        lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
        launches = json.loads(next(ln for ln in out.splitlines() if ln.startswith(EVAL_RESULT))[len(EVAL_RESULT):])
        return lines, launches["launches"]

    parsed = [parse(r, f"bdt-eval rank {i} of {n}") for i, r in enumerate(ranks)]
    (want,), want_launches = parse(alone, "bdt-eval, one process")
    check(len(parsed[0][0]) == 1 and not any(lines for lines, _ in parsed[1:]),
          f"bdt-eval over {n} processes printed {[len(lines) for lines, _ in parsed]} JSON lines by rank, "
          "not one from rank 0")
    got = parsed[0][0][0]
    rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    launches = [l for _, l in parsed]
    say("tile_dp", f"bdt-eval {DP_MEMBER} --data-parallel {n} over {n} NCCL process(es), 8 samples of 64x64, batch 8, "
                   f"f32 (TF32 off): {json.dumps(got)}; one process beside them {json.dumps(want)} ({multi_s:.1f} s "
                   f"wall for both); loss "
                   f"rel |d| {rel:.2e} (rtol 1e-6); edge-kernel launches by rank {launches}, one process "
                   f"{want_launches} ({smi})")
    check(sorted(got) == sorted(want) and all(got[m] == want[m] for m in want if m != "loss"),
          "bdt-eval over processes: the metrics differ from one process")
    check(rel <= 1e-6, f"bdt-eval over processes: the loss differs by rel {rel}")
    check(launches == [1] * n and want_launches == 1, "bdt-eval: not one edge-kernel launch a batch on each process")
    return sum(launches)


def int8_sites(model, min_ch: int):
    """(site, K, N) of every 1x1, stride-1, dilation-1 conv and separable
    pointwise step of ``model`` with at least ``min_ch`` input channels: the
    sites ``int8_pointwise=min_ch`` quantizes."""
    from building_detection_tpu_torch.nn import layers as L

    out = []
    for m in model.modules():
        if isinstance(m, L.SeparableConv2d):
            k, n = m.pointwise_kernel.shape[1], m.pointwise_kernel.shape[0]
        elif isinstance(m, L.Conv2d) and tuple(m.kernel.shape[2:]) == (1, 1) and m.strides == (1, 1) \
                and m.dilation == (1, 1):
            k, n = m.kernel.shape[1], m.kernel.shape[0]
        else:
            continue
        if k >= min_ch:
            out.append((m.jax_name, int(k), int(n)))
    return out


def phase_int_mm():
    """``torch._int_mm`` through ``int8_matmul`` at INT8_SITE against its
    int32 twin (``torch.matmul`` on int32, on the CPU: CUDA has no int32
    matmul), bit for bit; its time against a bf16 ``torch.matmul`` of the
    same shape (CUDA events, median of 20)."""
    import torch

    from building_detection_tpu_torch.nn import layers as L

    m, k, n = INT8_SITE
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    a = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
    b = wq.t()  # the layer's operand: the (N, K) codes viewed as (K, N)
    got = L.int8_matmul(a, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = L.int8_matmul_plain(a.cpu(), b.cpu())
    plain_cpu_s = time.perf_counter() - t0
    check(got.dtype == torch.int32 and torch.equal(got.cpu(), want), "_int_mm differs from its int32 twin")
    ms = cuda_ms(lambda: L.int8_matmul(a, b), 20)
    b_rows = b.contiguous()
    rows_ms = cuda_ms(lambda: torch._int_mm(a, b_rows), 20)
    xb, wb = a.to(torch.bfloat16), b.to(torch.bfloat16)
    bf16_ms = cuda_ms(lambda: torch.matmul(xb, wb), 20)
    ops = 2 * m * k * n
    say("int8", f"torch._int_mm at (M, K, N) = {INT8_SITE}: bit-equal to the int32 twin (twin on the CPU, "
                f"{plain_cpu_s:.1f} s); {ms:.4f} ms = {ops / ms / 1e9:.1f} TOP/s (right operand column-major, as the "
                f"layers call it; row-major {rows_ms:.4f} ms) against a bf16 torch.matmul of the same shape "
                f"{bf16_ms:.4f} ms = {ops / bf16_ms / 1e9:.1f} TFLOP/s (median of 20)")


def phase_int8(pipe):
    """The int8 path through its entry point: ``Pipeline(int8_pointwise=512,
    int8_calibration=<two smoke scenes>)`` on the card, bf16, the same seeded
    weights as ``pipe``.  ``predict_images`` over the smoke scenes is the
    counted run: every active site of every member goes through
    ``torch._int_mm`` once a chunk.  Then tiles/s of the five-member forward
    at 32 tiles of 512^2, int8 against bf16 (in turns), and the pixels each
    member's mask differs from the bf16 run's."""
    import torch

    from building_detection_tpu_torch.infer.pipeline import Pipeline
    from building_detection_tpu_torch.nn import layers as L
    from building_detection_tpu_torch.ops import tiling as T

    imgs = scenes()
    int8, build_s = timed(lambda: Pipeline(compute_dtype=torch.bfloat16, seed=SEED, int8_pointwise=INT8_MIN_CH,
                                           int8_calibration=imgs[:2]))
    sites = {name: int8_sites(model, INT8_MIN_CH) for name, model in int8.ensemble.models.items()}
    for name, found in sites.items():
        check(set(int8.int8_scales[name]) == {s for s, _, _ in found},
              f"{name}: calibrated sites {sorted(int8.int8_scales[name])} are not the active ones")
        padded = [f"{s} {k}->{n}" for s, k, n in found if k % 8 or n % 8]
        shapes = {}
        for _, k, n in found:
            shapes[f"{k}->{n}"] = shapes.get(f"{k}->{n}", 0) + 1
        say("int8", f"{name}: {len(found)} sites at >= {INT8_MIN_CH} input channels, K->N {json.dumps(shapes)}; "
                    f"padded for _int_mm: {padded or 'none'}")
    say("int8", f"Pipeline(int8_pointwise={INT8_MIN_CH}) built and calibrated on 2 scenes in {build_s:.1f} s")
    L.int8_matmul.calls = 0
    results, secs = timed(lambda: int8.predict_images(imgs))
    calls = L.int8_matmul.calls
    # one dispatch per scene shape here (the two 1024^2 scenes group), each of
    # ceil(tiles / batch_tiles) chunks; the 100x100 scene has no tile
    by_shape = {}
    for img in imgs:
        by_shape[img.shape[:2]] = by_shape.get(img.shape[:2], 0) + 1
    chunks = sum(-(-T.plan_tiles(h, w, int8.cfg.tiler).num_tiles * count // int8.batch_tiles)
                 for (h, w), count in by_shape.items())
    n_sites = sum(len(v) for v in sites.values())
    say("int8", f"predict_images over 4 scenes in {secs:.2f} s (first call): {calls} _int_mm launches "
                f"({n_sites} sites x {chunks} chunks)")
    check(calls == n_sites * chunks, f"{calls} _int_mm launches, expected {n_sites} sites x {chunks} chunks")
    check_results(imgs, results, int8.ensemble.names)
    want = pipe.predict_images(imgs)
    px = sum(img.shape[0] * img.shape[1] for img in imgs)
    diff = {name: sum(int((r.masks[name] != w.masks[name]).sum()) for r, w in zip(results, want))
            for name in int8.ensemble.names}
    say("int8", f"pixels differing int8 vs bf16 per member (of {px}): {json.dumps(diff)}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tile = pipe.cfg.tiler.tile
    tiles = (torch.rand((32, tile, tile, 3), generator=gen, device="cuda") * 2 - 1).to(torch.bfloat16)
    rates = {"bf16": [], "int8": []}
    with torch.inference_mode():
        for label in ("bf16", "int8", "int8", "bf16"):
            ens = pipe.ensemble if label == "bf16" else int8.ensemble
            rates[label].append(32 / (cuda_ms(lambda: ens.member_bits(tiles), 3) / 1000.0))
    say("int8", f"five-member forward, 32 tiles of {tile}^2: int8 "
                f"{' / '.join(f'{r:.2f}' for r in rates['int8'])} tiles/s, bf16 "
                f"{' / '.join(f'{r:.2f}' for r in rates['bf16'])} tiles/s (in turns bf16, int8, int8, bf16)")
    del int8, results, want, tiles
    torch.cuda.empty_cache()
    return calls


def h5_round_trip(work: str, repeats: int = 1):
    """The ``[h5]`` phase's files: the five members' seeded f32 weights
    written by ``export_h5_weights`` in Keras' layer order under the
    reference deployment's file names into ``work``, then imported back
    onto zeros ``repeats`` times on the host clock.  Returns ``(weights,
    paths, MiB, write seconds, [import seconds], the last import)``."""
    import numpy as np
    import torch

    from building_detection_tpu_torch.core.module import jax_variables
    from building_detection_tpu_torch.models.registry import ENSEMBLE_ORDER, init_model, keras_layer_order
    from building_detection_tpu_torch.train.checkpoint import export_h5_weights, import_h5_weights

    weights = {name: jax_variables(init_model(name, torch.Generator().manual_seed(SEED + 20 + i)))
               for i, name in enumerate(ENSEMBLE_ORDER)}
    paths = {name: os.path.join(work, H5_FILES[name]) for name in ENSEMBLE_ORDER}
    t0 = time.perf_counter()
    for name, (params, state) in weights.items():
        export_h5_weights(paths[name], params, state, layer_order=keras_layer_order(name))
    write_s = time.perf_counter() - t0
    mib = sum(os.path.getsize(p) for p in paths.values()) / 2**20
    read_s = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        back = {name: import_h5_weights(paths[name], *({k: np.zeros_like(v) for k, v in d.items()}
                                                        for d in weights[name]))
                for name in ENSEMBLE_ORDER}
        read_s.append(time.perf_counter() - t0)
    return weights, paths, mib, write_s, read_s, back


def h5_probe() -> int:
    """``chip_smoke.py --h5-probe``: ``h5_round_trip`` with
    ``H5_PROBE_REPEATS`` imports, for the port found first on ``sys.path``
    (the current directory's, so the same measurement runs against another
    checkout, in turns).  Prints one JSON line with each import's MiB/s."""
    import tempfile

    with tempfile.TemporaryDirectory(dir=os.getcwd()) as work:
        _, _, mib, write_s, read_s, _ = h5_round_trip(work, H5_PROBE_REPEATS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    port = os.path.dirname(sys.modules["building_detection_tpu_torch"].__file__)
    print("h5 probe " + json.dumps({"port": port, "mib": mib, "write_mib_s": mib / write_s,
                                    "import_mib_s": [mib / r for r in read_s], "smi": smi}), flush=True)
    return 0


def phase_h5(here: str, work: str, smi: str):
    """Keras ``.h5`` weights on this machine, which has no ``h5py``: the port
    reads and writes them itself (``utils/hdf5.py``).  The five members'
    seeded f32 weights are written in Keras' layer order under the reference
    deployment's file names and read back bit for bit (the import rate is
    printed with the card, ``smi``); one of them cut short by a few bytes is
    refused as truncated, as the HDF5 library refuses it;
    ``Pipeline(weights=discover_weights(dir))`` over the ``.h5`` files gives
    the bf16 masks of the same weights loaded from ``.npz`` (deterministic
    cuDNN); ``Trainer.load_weights`` of an ``.h5`` equals that of its
    ``.npz``; ``bdt-convert`` .npz -> .h5 -> .npz, as subprocesses, gives the
    weights back bit for bit.  ``h5py`` is never imported, and the phase
    launches no kernel."""
    import numpy as np
    import torch

    from building_detection_tpu_torch.core.config import TrainConfig
    from building_detection_tpu_torch.core.module import jax_variables
    from building_detection_tpu_torch.infer.pipeline import Pipeline, discover_weights
    from building_detection_tpu_torch.kernels import edge_weights as K
    from building_detection_tpu_torch.models.registry import ENSEMBLE_ORDER, keras_layer_order
    from building_detection_tpu_torch.train.checkpoint import import_h5_weights, load_variables, save_variables
    from building_detection_tpu_torch.train.trainer import Trainer

    def same(got, want, what):
        check(list(got) == list(want), f"{what}: the keys differ")
        for k in want:
            check(got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), f"{what}: {k} differs")

    t_phase = time.perf_counter()
    launches = K.edge_weight_maps.launches
    h5_dir, npz_dir = os.path.join(work, "h5"), os.path.join(work, "npz")
    os.makedirs(h5_dir)
    os.makedirs(npz_dir)
    weights, paths, mib, write_s, (read_s,), back = h5_round_trip(h5_dir)
    for name, (params, state) in weights.items():
        got_p, got_s, report = back[name]
        check(report.complete and report.matched_by_name == len(params) + len(state),
              f"{name}: the .h5 import was not complete by name: {report.summary()}")
        same(got_p, params, f"{name} .h5 params")
        same(got_s, state, f"{name} .h5 state")
        save_variables(os.path.join(npz_dir, f"{name}.npz"), params, state)
    del back
    check(discover_weights(h5_dir) == paths, f"discover_weights found {discover_weights(h5_dir)}")
    layers = {name: len(keras_layer_order(name)) for name in ENSEMBLE_ORDER}
    say("h5", f"wrote the five members' .h5 ({', '.join(H5_FILES[n] for n in ENSEMBLE_ORDER)}; {mib:.1f} MiB, "
              f"{max(layers.values())} layer groups at most) in {write_s:.2f} s ({mib / write_s:.0f} MiB/s), "
              f"imported them back in {read_s:.2f} s ({mib / read_s:.0f} MiB/s), bit for bit, each file's end "
              f"checked against its superblock (h5py's default format carries no checksum); on {smi}")
    cut, short = 3, os.path.join(work, "truncated.h5")
    with open(paths["hrnet"], "rb") as src, open(short, "wb") as dst:
        dst.write(src.read()[:-cut])
    refused = ""
    try:
        import_h5_weights(short, *weights["hrnet"])
    except ValueError as e:
        refused = str(e)
    check("truncated HDF5 file" in refused, f"a .h5 cut {cut} bytes short was not refused as truncated ({refused!r})")
    say("h5", f"{H5_FILES['hrnet']} cut {cut} bytes short is refused: {refused}")

    img = scenes()[0]
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        masks = []
        for d in (npz_dir, h5_dir):
            pipe = Pipeline(weights=discover_weights(d), compute_dtype=torch.bfloat16, seed=SEED)
            masks.append(pipe.ensemble.predict_masks(img))
            del pipe
            torch.cuda.empty_cache()
        for name in ENSEMBLE_ORDER:
            check(np.array_equal(masks[0][name], masks[1][name]), f"{name}: the .h5 Pipeline's mask differs")
        member = "hrnet"
        trained = []
        for path in (paths[member], os.path.join(npz_dir, f"{member}.npz")):
            tr = Trainer(member, TrainConfig(), compute_dtype=torch.bfloat16)
            check(next(tr.model.parameters()).is_cuda, "the Trainer is not on the card")
            tr.load_weights(path)
            trained.append(jax_variables(tr.model))
            del tr
        for (got_p, got_s), what in zip(trained, (".h5", ".npz")):
            same(got_p, weights[member][0], f"Trainer.load_weights({what}) params")
            same(got_s, weights[member][1], f"Trainer.load_weights({what}) state")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    torch.cuda.empty_cache()
    say("h5", f"Pipeline(weights=discover_weights(.h5 dir)) bf16 masks equal the .npz Pipeline's on a "
              f"{img.shape[0]}x{img.shape[1]} scene, all five members; Trainer({member!r}).load_weights of the .h5 "
              f"equals that of the .npz")

    npz, h5, again = (os.path.join(work, n) for n in ("scse.npz", "scse_cli.h5", "scse_back.npz"))
    save_variables(npz, *weights["scse"])
    _, to_h5 = run_cli(here, "convert", ["scse", npz, h5], "bdt-convert npz->h5")
    _, to_npz = run_cli(here, "convert", ["scse", h5, again], "bdt-convert h5->npz")
    got_p, got_s, *_ = load_variables(again)
    want_p, want_s, *_ = load_variables(npz)
    same(got_p, want_p, "bdt-convert params")
    same(got_s, want_s, "bdt-convert state")
    check("h5py" not in sys.modules, "h5py was imported")
    installed = importlib.util.find_spec("h5py") is not None  # looked up, not imported
    check(K.edge_weight_maps.launches == launches, "the .h5 phase launched the edge-weight kernel")
    say("h5", f"bdt-convert npz -> h5 {to_h5:.1f} s, h5 -> npz {to_npz:.1f} s, weights back bit for bit; h5py "
              f"never imported ({'installed' if installed else 'not installed'} on this machine); phase "
              f"{time.perf_counter() - t_phase:.1f} s")


def phase_remat():
    """``Trainer(remat=True)`` against ``remat=False``, REMAT_MEMBER at
    512x512, batch 8, on the card.  f32 with TF32 off and deterministic
    cuDNN: one step each way gives the same loss, params and BN statistics.
    bf16: peak device memory and ms per step each way.  Returns the
    edge-kernel launches of these steps."""
    import numpy as np
    import torch

    from building_detection_tpu_torch.core.config import TrainConfig
    from building_detection_tpu_torch.core.module import jax_variables
    from building_detection_tpu_torch.kernels import edge_weights as K
    from building_detection_tpu_torch.train.trainer import Trainer

    cfg = TrainConfig(warmup_epochs=0)
    imgs, labs = train_batch(SEED + 14, cfg.batch_size, cfg.image_size)
    before = K.edge_weight_maps.launches
    saved = exact_f32()
    try:
        runs = {}
        for remat in (False, True):
            tr = Trainer(REMAT_MEMBER, cfg, seed=SEED, remat=remat)
            loss = tr.train_on_batch(imgs, labs)["loss"]
            runs[remat] = (loss, *jax_variables(tr.model))
            del tr
        (l0, p0, s0), (l1, p1, s1) = runs[False], runs[True]
        dp = max(float(np.abs(p0[k] - p1[k]).max()) for k in p0)
        ds = max(float(np.abs(s0[k] - s1[k]).max()) for k in s0)
        say("remat", f"{REMAT_MEMBER} f32, TF32 off, deterministic cuDNN, one step: loss {l1!r} with remat, {l0!r} "
                     f"without; params max |d| {dp:.3e}, BN statistics max |d| {ds:.3e}")
        check(l0 == l1 and dp == 0.0 and ds == 0.0, "remat changed the f32 step")
    finally:
        restore_backends(saved)
        torch.cuda.empty_cache()
    out = {}
    for remat in (False, True, True, False):
        tr = Trainer(REMAT_MEMBER, cfg, seed=SEED, compute_dtype=torch.bfloat16, remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        times = []
        for _ in range(REMAT_STEPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            tr.train_on_batch(imgs, labs)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        peak = torch.cuda.max_memory_allocated()
        out.setdefault(remat, []).append((statistics.median(times[1:]), (peak - base) / 2**30, peak / 2**30))
        del tr
        torch.cuda.empty_cache()
    for remat in (False, True):
        say("remat", f"{REMAT_MEMBER} bf16 {'remat' if remat else 'plain'}: "
                     + "; ".join(f"{ms:.1f} ms/step, peak {peak:.2f} GiB ({above:.2f} above the model and batch)"
                                 for ms, above, peak in out[remat])
                     + f" (median of steps 2-{REMAT_STEPS}; two runs, in turns plain, remat, remat, plain)")
    check(max(a for _, a, _ in out[True]) < min(a for _, a, _ in out[False]), "remat did not lower the peak memory")
    return K.edge_weight_maps.launches - before


def port_env(here: str) -> dict:
    return dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))


def run_cli(here: str, module: str, args, tag: str):
    """Run ``python -m building_detection_tpu_torch.cli.<module>`` to its end;
    returns (stdout, seconds)."""
    t0 = time.perf_counter()
    done = subprocess.run([sys.executable, "-m", f"building_detection_tpu_torch.cli.{module}", *args], cwd=here,
                          env=port_env(here), capture_output=True, text=True, timeout=CLI_TIMEOUT_S)
    secs = time.perf_counter() - t0
    check(done.returncode == 0, f"{tag} exited {done.returncode}: {done.stderr[-3000:]}")
    return done.stdout, secs


def tree(root: str) -> dict:
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(dirpath, f), "rb") as fh:
                out[os.path.relpath(os.path.join(dirpath, f), root)] = fh.read()
    return out


def phase_predict_cli(here: str, work: str):
    """``bdt-predict`` on its default device over a directory of four PNG
    scenes with ``--keep-intermediates``; then the same directory in two
    shards run side by side, whose union equals the single run file for
    file.  The two 1024^2 scenes share a shard (crc32 of their names), so
    every scene meets the same batch shapes as in the single run."""
    import numpy as np
    from PIL import Image

    from building_detection_tpu_torch.cli.predict import shard_of

    scene_dir = os.path.join(work, "scenes")
    os.makedirs(scene_dir)
    rng = np.random.RandomState(SEED + 10)
    for name, (h, w) in CLI_SCENES.items():
        Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(os.path.join(scene_dir, f"{name}.png"))
    check(shard_of("a.png", 2) == shard_of("b.png", 2), "the two 1024^2 scenes fall in different shards")
    single = os.path.join(work, "single")
    stdout, secs = run_cli(here, "predict", ["--image-dir", scene_dir, "--out", single, "--keep-intermediates"],
                           "bdt-predict")
    lines = [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]
    check(len(lines) == len(CLI_SCENES), f"bdt-predict printed {len(lines)} JSON lines for {len(CLI_SCENES)} scenes")
    members = ("res34", "hrnet", "v3plus", "scse", "bam")
    for name, (h, w) in CLI_SCENES.items():
        files = set(os.listdir(os.path.join(single, name)))
        check(files == {f"{name}_result.png", f"{name}.txt"} | {f"{m}_{name}.png" for m in members},
              f"bdt-predict wrote {sorted(files)} for scene {name}")
        with Image.open(os.path.join(single, name, f"{name}_result.png")) as im:
            result = np.asarray(im)
        check(result.shape == (h, w), f"scene {name}: result {result.shape}")
        if (h, w) == (100, 100):
            check(not result.any(), "the 100x100 scene (no tile) is not blank")
    say("predict-cli", f"one process over {len(CLI_SCENES)} scenes: {secs:.1f} s wall, the contract files and one "
                       f"JSON line per scene; the 100x100 scene blank")
    fleet = os.path.join(work, "fleet")
    cmd = [sys.executable, "-m", "building_detection_tpu_torch.cli.predict", "--image-dir", scene_dir, "--out", fleet,
           "--keep-intermediates", "--num-processes", "2"]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd + ["--process-id", str(i)], cwd=here, env=port_env(here),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for i in range(2)]
    try:
        outs = [p.communicate(timeout=CLI_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    secs = time.perf_counter() - t0
    for i, (p, (_, err)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"bdt-predict shard {i} exited {p.returncode}: {err[-3000:]}")
    check(tree(fleet) == tree(single), "the two shards' union differs from the single run")
    say("predict-cli", f"two shards side by side: {secs:.1f} s wall; their union equals the single run, file for file")


def phase_serve_cli(here: str, work: str):
    """``bdt-serve --port 0`` on its default device: read the bound port,
    ``GET /health``, three PNG ``POST /photo`` requests through the port's
    ``bdt-client`` (``detect``), the client CLI once, then SIGTERM: the
    process prints its drain line and exits 0."""
    import http.client
    import queue
    import signal
    import threading

    import numpy as np
    from PIL import Image

    from building_detection_tpu_torch.serve import client

    cmd = [sys.executable, "-u", "-m", "building_detection_tpu_torch.cli.serve", "--host", "127.0.0.1", "--port", "0",
           "--root-dir", work]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=here, env=port_env(here), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    lines: "queue.Queue" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(line) for line in proc.stdout] + [lines.put(None)], daemon=True).start()
    log = []

    def read_until(pred, timeout: float):
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            try:
                line = lines.get(timeout=max(end - time.monotonic(), 0.01))
            except queue.Empty:
                break
            if line is None:
                break
            log.append(line.rstrip())
            if pred(line):
                return line
        return None

    try:
        line = read_until(lambda s: s.startswith("serving on "), CLI_TIMEOUT_S)
        check(line is not None, f"bdt-serve never printed its address: {log[-20:]}")
        port = int(line.rsplit(":", 1)[1])
        ready_s = time.perf_counter() - t0
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        conn.request("GET", "/health")
        health = conn.getresponse()
        check(health.status == 200, f"GET /health answered {health.status}")
        health.read()
        conn.close()
        rng = np.random.RandomState(SEED + 11)
        url = f"http://127.0.0.1:{port}/photo"
        times = []
        for i in range(3):
            path = os.path.join(work, f"scene{i}.png")
            Image.fromarray(rng.randint(0, 256, (600, 800, 3)).astype(np.uint8)).save(path)
            t1 = time.perf_counter()
            answer = client.detect(path, url=url, client_id="smoke")
            times.append(time.perf_counter() - t1)
            check(answer["status"] == "success", f"POST /photo answered {answer['status']}: {answer['error']}")
        saved_png = os.path.join(work, "client_result.png")
        t1 = time.perf_counter()
        done = subprocess.run([sys.executable, "-m", "building_detection_tpu_torch.serve.client", path, "--url", url,
                               "--save", saved_png], cwd=here, env=port_env(here), capture_output=True, text=True,
                              timeout=CLI_TIMEOUT_S)
        client_s = time.perf_counter() - t1
        check(done.returncode == 0, f"bdt-client exited {done.returncode}: {done.stdout[-2000:]} {done.stderr[-2000:]}")
        line = json.loads(done.stdout.strip().splitlines()[-1])
        with Image.open(saved_png) as im:
            check(line["status"] == "success" and im.size == (800, 600), f"bdt-client: {line}, saved {im.size}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=CLI_TIMEOUT_S)
        read_until(lambda s: False, 10)
        check(rc == 0, f"bdt-serve exited {rc} after SIGTERM: {log[-20:]}")
        check(any(s.startswith("drained") for s in log), f"bdt-serve printed no drain line: {log[-20:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    say("serve-cli", f"bdt-serve ready (warmed up, bound to port {port}) {ready_s:.1f} s after start; /health 200; "
                     f"3 POST /photo through client.detect, success in {' / '.join(f'{t:.2f}' for t in times)} s; "
                     f"bdt-client CLI success in {client_s:.2f} s wall, result image saved; SIGTERM: "
                     f"{[s for s in log if s.startswith(('signal', 'drained'))]}, exit 0")


def phase_augment_cli(here: str, work: str):
    """``bdt-augment`` over four 512^2 PNG pairs with ``--split-dir`` (host only)."""
    import numpy as np
    from PIL import Image

    imgs, labs = os.path.join(work, "img"), os.path.join(work, "lab")
    os.makedirs(imgs)
    os.makedirs(labs)
    rng = np.random.RandomState(SEED + 12)
    for i in range(4):
        Image.fromarray(rng.randint(0, 256, (512, 512, 3)).astype(np.uint8)).save(os.path.join(imgs, f"{i}.png"))
        lab = ((labels_np(SEED + 20 + i, (1, 512, 512))[0] > 0) * 255).astype(np.uint8)
        Image.fromarray(lab).save(os.path.join(labs, f"{i}.png"))
    out_i, out_l, split = (os.path.join(work, d) for d in ("aug_img", "aug_lab", "split"))
    stdout, secs = run_cli(here, "augment", ["--images", imgs, "--labels", labs, "--out-images", out_i,
                                             "--out-labels", out_l, "--split-dir", split, "--seed", str(SEED)],
                           "bdt-augment")
    n = len(os.listdir(out_i))
    split_n = sum(len(os.listdir(os.path.join(split, d, "images"))) for d in ("train", "val"))
    check(n >= 4 and n == len(os.listdir(out_l)) == split_n, f"bdt-augment wrote {n} pairs, split {split_n}")
    say("augment-cli", f"{n} pairs from 4 and the split in {secs:.1f} s wall: {stdout.strip().splitlines()[-1]}")


def train_batch(seed: int, n: int, px: int):
    """A learnable uint8 batch: dark noisy ground, bright blobs where the
    label is 255 (numpy only)."""
    import numpy as np

    lab = labels_np(seed, (n, px, px)) > 0
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 90, (n, px, px, 3))
    img[lab] += rng.randint(100, 166, (int(lab.sum()), 3))
    return img.astype(np.uint8), (lab * 255).astype(np.uint8)


def phase_train_parity():
    """One f32 Trainer step per member, card vs CPU, same seeded weights and batch."""
    import numpy as np
    import torch

    from building_detection_tpu_torch.core.config import TrainConfig
    from building_detection_tpu_torch.core.module import jax_variables
    from building_detection_tpu_torch.models.registry import ENSEMBLE_ORDER
    from building_detection_tpu_torch.train.trainer import Trainer

    cfg = TrainConfig(batch_size=2, image_size=TRAIN_PARITY_PX, epochs=1, warmup_epochs=1)
    imgs, labs = train_batch(SEED + 4, 2, TRAIN_PARITY_PX)
    saved = exact_f32()
    try:
        for i, name in enumerate(ENSEMBLE_ORDER):
            runs = {}
            for dev in ("cuda", "cpu"):
                on = {} if dev == "cuda" else {"device": "cpu"}  # the card is the default
                tr = Trainer(name, cfg, steps_per_epoch=3, seed=SEED + i, **on)
                loss = tr.train_on_batch(imgs, labs)["loss"]
                runs[dev] = (loss, *jax_variables(tr.model))
            (lc, pc, sc), (lh, ph, sh) = runs["cuda"], runs["cpu"]
            check(np.isfinite(lc), f"{name}: non-finite train loss on the card")
            dp = max(float(np.abs(pc[k] - ph[k]).max()) for k in ph)
            ds = max((float(np.abs(sc[k] - sh[k]).max()) - TRAIN_STATE_RTOL * float(np.abs(sh[k]).max())
                      for k in sh), default=0.0)
            say("train-parity", f"{name}: loss card {lc:.7f} cpu {lh:.7f} (|d| {abs(lc - lh):.2e}, atol "
                                f"{TRAIN_LOSS_ATOL}); params max |d| {dp:.2e} (atol {TRAIN_PARAM_ATOL}); BN stats "
                                f"max |d| beyond {TRAIN_STATE_RTOL} x scale {ds:.2e} (atol {TRAIN_STATE_ATOL})")
            check(abs(lc - lh) <= TRAIN_LOSS_ATOL, f"{name}: train loss card vs CPU differs by {abs(lc - lh)}")
            check(dp <= TRAIN_PARAM_ATOL, f"{name}: params after one step differ by {dp}")
            check(ds <= TRAIN_STATE_ATOL, f"{name}: BN moving statistics after one step differ")
    finally:
        restore_backends(saved)


def phase_train_full():
    """The counted training run: each member at 512x512, batch 8, on the card,
    TRAIN_STEPS steps on one fixed batch, f32 and bf16."""
    import torch

    from building_detection_tpu_torch.core.config import TrainConfig
    from building_detection_tpu_torch.kernels import edge_weights as K
    from building_detection_tpu_torch.models.registry import ENSEMBLE_ORDER
    from building_detection_tpu_torch.train.trainer import Trainer

    cfg = TrainConfig(warmup_epochs=0)
    imgs, labs = train_batch(SEED + 5, cfg.batch_size, cfg.image_size)
    K.edge_weight_maps.launches = 0
    for dtype in (torch.float32, torch.bfloat16):
        for i, name in enumerate(ENSEMBLE_ORDER):
            tr = Trainer(name, cfg, seed=SEED + i, compute_dtype=dtype)
            check(tr.device.type == "cuda", f"Trainer() trains on {tr.device}, not the card")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = K.edge_weight_maps.launches
            losses, times = [], []
            for _ in range(TRAIN_STEPS):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                metrics = tr.train_on_batch(imgs, labs)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
                losses.append(metrics["loss"])
            launched = K.edge_weight_maps.launches - before
            peak = torch.cuda.max_memory_allocated() / 2**30
            ms = statistics.median(times[1:])
            tag = f"{name} {str(dtype).replace('torch.', '')}"
            say("train", f"{tag}: losses {' '.join(f'{v:.4f}' for v in losses)}; {ms:.1f} ms/step "
                         f"(median of steps 2-{TRAIN_STEPS}; first {times[0]:.1f}), "
                         f"{cfg.batch_size / (ms / 1000.0):.2f} images/s, peak {peak:.2f} GiB, kernel launches {launched}")
            check(all(math.isfinite(v) for v in losses), f"{tag}: non-finite loss")
            check(losses[-1] < losses[0], f"{tag}: loss did not fall over {TRAIN_STEPS} steps on one batch")
            check(launched == TRAIN_STEPS, f"{tag}: {launched} edge-kernel launches in {TRAIN_STEPS} steps")
            del tr
            torch.cuda.empty_cache()
    return K.edge_weight_maps.launches


def phase_train_resume_and_staged():
    """res34 at full width, f32, deterministic cuDNN: save -> restore gives the
    uninterrupted run's next loss, and a staged 2-step epoch equals two
    train_on_batch calls, bit for bit."""
    import tempfile

    import numpy as np
    import torch

    from building_detection_tpu_torch.core.config import TrainConfig
    from building_detection_tpu_torch.core.module import jax_variables
    from building_detection_tpu_torch.train.trainer import Trainer

    cfg = TrainConfig(warmup_epochs=0)
    b = cfg.batch_size
    imgs, labs = train_batch(SEED + 6, 2 * b, cfg.image_size)
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as root:
            path = os.path.join(root, "step1.npz")
            a = Trainer("res34", cfg, seed=SEED)
            a.train_on_batch(imgs[:b], labs[:b])
            a.save(path)
            want = a.train_on_batch(imgs[b:], labs[b:])["loss"]
            fresh = Trainer("res34", cfg, seed=SEED + 9)
            fresh.restore(path)
            check(fresh.step == 1, f"restored step {fresh.step}, saved 1")
            got = fresh.train_on_batch(imgs[b:], labs[b:])["loss"]
            say("train-ckpt", f"res34: next loss after restore {got!r}, uninterrupted {want!r}")
            check(got == want, "restore did not reproduce the uninterrupted run's next loss")
            del a, fresh
        loop = Trainer("res34", cfg, seed=SEED)
        loop_losses = [loop.train_on_batch(imgs[i * b:(i + 1) * b], labs[i * b:(i + 1) * b])["loss"]
                       for i in range(2)]
        staged = Trainer("res34", cfg, seed=SEED)
        metrics = staged.train_epoch_staged(*staged.stage_dataset(imgs, labs))
        pl, ps = jax_variables(loop.model)
        pst, sst = jax_variables(staged.model)
        dp = max(float(np.abs(pl[k] - pst[k]).max()) for k in pl)
        say("train-staged", f"res34: staged losses {metrics['loss'].tolist()}, per-step {loop_losses}; "
                            f"params max |d| {dp:.3e}")
        check(metrics["loss"].tolist() == loop_losses, "staged epoch losses differ from train_on_batch")
        check(dp == 0.0 and all(np.array_equal(ps[k], sst[k]) for k in ps),
              "staged epoch params/BN state differ from train_on_batch")
        del loop, staged
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


DP_RESULT = "dp result "


def dp_child(spec: dict) -> int:
    """One process of the ``[dp]`` phase (``chip_smoke.py --dp-child SPEC``):
    ``spec['leg']`` is ``'nccl'`` (world size 1) or ``'gloo'`` (one of two
    ranks on cuda:0).  Prints one ``dp result`` JSON line."""
    import numpy as np
    import torch

    from building_detection_tpu_torch.core.config import TrainConfig
    from building_detection_tpu_torch.core.module import jax_variables
    from building_detection_tpu_torch.kernels import edge_weights as K
    from building_detection_tpu_torch.parallel import distributed as pdist
    from building_detection_tpu_torch.parallel.mesh import make_mesh
    from building_detection_tpu_torch.train.trainer import Trainer

    cfg = TrainConfig(warmup_epochs=0)
    imgs, labs = train_batch(SEED + 15, cfg.batch_size, cfg.image_size)
    from building_detection_tpu_torch.train import trainer as trainer_module

    shapes = []
    targets_edges = trainer_module.edge_weight_maps

    def recorded(label, *args):
        shapes.append(tuple(label.shape))
        return targets_edges(label, *args)

    trainer_module.edge_weight_maps = recorded  # the labels make_targets hands to the kernel's wrapper
    launch = K.edge_weight_maps
    out = {"leg": spec["leg"]}
    if spec["leg"] == "nccl":
        pdist.init_distributed(f"127.0.0.1:{spec['port']}", 1, 0, backend="nccl")
    else:
        pdist.init_distributed(f"127.0.0.1:{spec['port']}", 2, spec["rank"], backend="gloo")
    try:
        mesh = make_mesh()
        out.update(data=mesh.data, rank=mesh.rank, backend=mesh.backend, device=str(mesh.device))
        launch.launches = 0
        if spec["leg"] == "nccl":
            saved = exact_f32()
            by_kind = {"mesh": 0, "plain": 0}  # edge-kernel launches of the mesh steps and of the plain ones
            try:
                runs = {}
                for kind in ("mesh", "plain"):
                    tr = Trainer(DP_MEMBER, cfg, seed=SEED, mesh=mesh if kind == "mesh" else None)
                    before = launch.launches
                    loss = tr.train_on_batch(imgs, labs)["loss"]
                    by_kind[kind] += launch.launches - before
                    params, state = jax_variables(tr.model)
                    runs[kind] = (loss, params, state, str(tr.device))
                    del tr
            finally:
                restore_backends(saved)
            (lm, pm, sm, dev), (lp, pp, sp, _) = runs["mesh"], runs["plain"]
            out["f32"] = {"loss_mesh": lm, "loss_plain": lp, "device": dev,
                          "params_equal": all(np.array_equal(pm[k], pp[k]) for k in pp),
                          "state_equal": all(np.array_equal(sm[k], sp[k]) for k in sp)}
            bf16 = []
            for kind in ("plain", "mesh", "mesh", "plain"):
                torch.cuda.empty_cache()
                tr = Trainer(DP_MEMBER, cfg, seed=SEED, compute_dtype=torch.bfloat16,
                             mesh=mesh if kind == "mesh" else None)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                times = []
                before = launch.launches
                for _ in range(DP_STEPS):
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record()
                    tr.train_on_batch(imgs, labs)
                    end.record()
                    end.synchronize()
                    times.append(start.elapsed_time(end))
                by_kind[kind] += launch.launches - before
                bf16.append({"kind": kind, "ms": statistics.median(times[1:]), "first_ms": times[0],
                             "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
                del tr
            out["bf16"] = bf16
            out["steps"] = 2 + 4 * DP_STEPS
            out["launches_by_kind"] = by_kind
        else:
            saved = exact_f32()
            try:
                tr = Trainer(DP_MEMBER, cfg, seed=SEED, mesh=mesh)
                losses, times = [], []
                for _ in range(DP_GLOO_STEPS):
                    t0 = time.perf_counter()
                    losses.append(tr.train_on_batch(imgs, labs)["loss"])
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                params, state = jax_variables(tr.model)
            finally:
                restore_backends(saved)
            np.savez(os.path.join(spec["out"], f"rank{mesh.rank}.npz"), **{f"p/{k}": v for k, v in params.items()},
                     **{f"s/{k}": v for k, v in state.items()})
            out.update(losses=losses, ms=times, device=str(tr.device), steps=DP_GLOO_STEPS)
        out.update(launches=launch.launches, shapes=sorted(set(shapes)))
    finally:
        pdist.destroy()
    print(DP_RESULT + json.dumps(out), flush=True)
    return 0


def dp_results(runs, what: str) -> list:
    out = []
    for i, (rc, text) in enumerate(runs):
        check(rc == 0, f"{what}: process {i} exited {rc}: {text[-4000:]}")
        out.append(json.loads(next(ln for ln in text.splitlines() if ln.startswith(DP_RESULT))[len(DP_RESULT):]))
    return out


def phase_dp(here: str, work: str, smi: str) -> tuple:
    """Data-parallel training (``parallel/``), every leg in child processes:
    NCCL at world size 1 (f32 bit-equal to a plain Trainer, bf16 time and
    peak memory beside it), two Gloo ranks on cuda:0 against one process,
    and a world-size-1 ``bdt-train`` through the multi-process flags.
    Returns the edge-kernel launches of the children's data-parallel steps
    and of their plain comparison steps."""
    import numpy as np
    import torch

    from building_detection_tpu_torch.core.config import TrainConfig
    from building_detection_tpu_torch.parallel import dryrun
    from building_detection_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    me = os.path.abspath(__file__)
    env = port_env(here)

    def child(spec):
        return [sys.executable, me, "--dp-child", json.dumps(spec)]

    (nccl,) = dp_results(dryrun.run_processes([child({"leg": "nccl", "port": dryrun.free_port()})], env,
                                              DP_TIMEOUT_S, cwd=here), "NCCL world size 1")
    f32 = nccl["f32"]
    say("dp", f"NCCL world size 1 on {f32['device']}, {DP_MEMBER} 512x512 batch 8, f32, TF32 off, deterministic "
              f"cuDNN, one step: loss {f32['loss_mesh']!r} with the mesh, {f32['loss_plain']!r} plain; params "
              f"{'bit-equal' if f32['params_equal'] else 'DIFFER'}, BN state "
              f"{'bit-equal' if f32['state_equal'] else 'DIFFER'} ({smi})")
    check(nccl["data"] == 1 and nccl["backend"] == "nccl", f"NCCL mesh: {nccl}")
    check(f32["loss_mesh"] == f32["loss_plain"] and f32["params_equal"] and f32["state_equal"],
          "the NCCL world-size-1 step differs from the plain Trainer's")
    by_kind = {}
    for run in nccl["bf16"]:
        by_kind.setdefault(run["kind"], []).append(run)
    for kind in ("plain", "mesh"):
        say("dp", f"NCCL world size 1 {DP_MEMBER} bf16 {kind}: "
                  + "; ".join(f"{r['ms']:.1f} ms/step (first {r['first_ms']:.1f}), peak {r['peak_gib']:.2f} GiB"
                              for r in by_kind[kind])
                  + f" (median of steps 2-{DP_STEPS}, CUDA events; in turns plain, mesh, mesh, plain; {smi})")
    check(nccl["launches"] == nccl["steps"] and nccl["shapes"] == [[8, 512, 512]],
          f"NCCL leg: {nccl['launches']} edge-kernel launches for {nccl['steps']} steps on {nccl['shapes']}")
    kinds = nccl["launches_by_kind"]
    check(kinds == {"mesh": 1 + 2 * DP_STEPS, "plain": 1 + 2 * DP_STEPS},
          f"NCCL leg: edge-kernel launches of the mesh and plain steps {kinds}")

    port = dryrun.free_port()
    gloo = dp_results(dryrun.run_processes(
        [child({"leg": "gloo", "port": port, "rank": r, "out": work}) for r in range(2)], env, DP_TIMEOUT_S, cwd=here
    ), "Gloo world size 2")
    with np.load(os.path.join(work, "rank0.npz")) as z0, np.load(os.path.join(work, "rank1.npz")) as z1:
        same = sorted(z0.files) == sorted(z1.files) and all(np.array_equal(z0[k], z1[k]) for k in z0.files)
    cfg = TrainConfig(warmup_epochs=0)
    imgs, labs = train_batch(SEED + 15, cfg.batch_size, cfg.image_size)
    saved = exact_f32()
    try:
        single = Trainer(DP_MEMBER, cfg, seed=SEED)
        want = [single.train_on_batch(imgs, labs)["loss"] for _ in range(DP_GLOO_STEPS)]
        del single
    finally:
        restore_backends(saved)
        torch.cuda.empty_cache()
    got = gloo[0]["losses"]
    rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
    say("dp", f"Gloo world size 2, both ranks on {gloo[0]['device']}, {DP_MEMBER} 512x512 f32, TF32 off, global "
              f"batch 8 (4 a rank), {DP_GLOO_STEPS} steps: losses {got} (rank 1 {gloo[1]['losses']}), one process "
              f"{want}, max rel |d| {rel:.2e} (rtol {DP_LOSS_RTOL}); ranks' params and BN state "
              f"{'bit-identical' if same else 'DIFFER'}; edge kernel on {gloo[0]['shapes']} "
              f"{gloo[0]['launches']} / {gloo[1]['launches']} launches; step "
              + " / ".join(f"{ms:.1f}" for ms in gloo[0]["ms"])
              + f" ms on rank 0 (host clock; Gloo carries every all-reduce through the host: a check, not the "
              f"production path; {smi})")
    check(all(g["data"] == 2 and g["backend"] == "gloo" for g in gloo), f"Gloo mesh: {gloo}")
    check(got == gloo[1]["losses"] and same, "the two Gloo ranks disagree")
    check(rel <= DP_LOSS_RTOL, f"two ranks vs one process: losses differ by rel {rel}")
    check(all(g["launches"] == DP_GLOO_STEPS and g["shapes"] == [[4, 512, 512]] for g in gloo),
          f"Gloo leg: edge-kernel launches {[(g['launches'], g['shapes']) for g in gloo]}")

    data = os.path.join(work, "data")
    rng = np.random.RandomState(SEED + 16)
    from PIL import Image

    for sub in ("img", "lab"):
        os.makedirs(os.path.join(data, sub))
    for i in range(8):
        img, lab = train_batch(SEED + 30 + i, 1, 64)
        Image.fromarray(img[0]).save(os.path.join(data, "img", f"{i}.png"))
        Image.fromarray(lab[0]).save(os.path.join(data, "lab", f"{i}.png"))
    ck = os.path.join(work, "ck")
    stdout, secs = run_cli(here, "train", [
        DP_MEMBER, "--train-images", os.path.join(data, "img"), "--train-labels", os.path.join(data, "lab"),
        "--checkpoint-dir", ck, "--batch-size", "8", "--epochs", "1", "--warmup-epochs", "0", "--image-size", "64",
        "--coordinator", f"127.0.0.1:{dryrun.free_port()}", "--num-processes", "1", "--process-id", "0",
    ], "bdt-train --num-processes 1")
    path = os.path.join(ck, "epoch_1_weights.npz")
    check(os.path.exists(path), f"bdt-train wrote no checkpoint: {stdout[-2000:]}")
    back = Trainer(DP_MEMBER, TrainConfig(batch_size=8, image_size=64), seed=SEED + 3)
    back.restore(path)
    check(back.step == 1, f"the checkpoint restored at step {back.step}, not 1")
    del back
    torch.cuda.empty_cache()
    say("dp", f"bdt-train --coordinator 127.0.0.1:PORT --num-processes 1 --process-id 0 on the card (NCCL): exit 0 "
              f"in {secs:.1f} s wall, its checkpoint restores at step 1; phase {time.perf_counter() - t0:.1f} s "
              f"({smi})")
    return kinds["mesh"] + sum(g["launches"] for g in gloo), kinds["plain"]


def hybrid_body(args) -> int:
    """One launched worker of the ``[hybrid]`` phase, in place of
    ``bdt-train``'s body (the launcher pickles it by name): ``bdt-train``'s
    own body on ``args`` in f32 with TF32 off, ``bdt-eval``'s body on layout
    (a)'s checkpoint, then bf16 steps of a ``Trainer`` over the ranks, timed
    by CUDA events.  Every label batch ``make_targets`` hands the edge
    kernel is held against its twin.  Writes ``<layout>_rank<r>.json`` beside
    the checkpoint directory."""
    import contextlib
    import io

    import torch
    import torch.distributed as dist

    from building_detection_tpu_torch.cli import evaluate as cli_eval
    from building_detection_tpu_torch.cli import train as cli_train
    from building_detection_tpu_torch.core.config import TrainConfig
    from building_detection_tpu_torch.kernels import edge_weights as K
    from building_detection_tpu_torch.parallel.mesh import make_mesh
    from building_detection_tpu_torch.train import trainer as trainer_module
    from building_detection_tpu_torch.train.trainer import Trainer

    calls = []
    targets_edges = trainer_module.edge_weight_maps

    def recorded(label, *rest):
        before = K.edge_weight_maps.launches
        got = targets_edges(label, *rest)
        launched = K.edge_weight_maps.launches - before
        want = K.edge_weight_maps_plain(label, *rest)
        calls.append({"shape": list(label.shape), "launches": launched,
                      "equal": all(torch.equal(g, w) for g, w in zip(got, want))})
        return got

    trainer_module.edge_weight_maps = recorded  # the labels make_targets hands to the kernel's wrapper
    root, layout = os.path.split(os.path.abspath(args.checkpoint_dir))
    rank = dist.get_rank()
    K.edge_weight_maps.launches = 0
    saved = exact_f32()
    try:
        start = time.perf_counter()
        cli_train.train(args)
        train_s = time.perf_counter() - start
        dist.barrier()  # rank 0 has written the checkpoint
        eval_args = cli_eval.build_parser().parse_args([
            args.model, "--checkpoint", os.path.join(root, "a", "epoch_1_weights.npz"), "--images",
            args.train_images, "--labels", args.train_labels, "--batch-size", str(args.batch_size), "--image-size",
            str(args.image_size), "--precision", "f32", "--device", args.device, "--num-processes", "0",
        ])
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            cli_eval.evaluate(eval_args)
    finally:
        restore_backends(saved)
    f32_launches = K.edge_weight_maps.launches
    cfg = TrainConfig(batch_size=args.batch_size, image_size=args.image_size, warmup_epochs=0)
    imgs, labs = train_batch(SEED + 70, cfg.batch_size, cfg.image_size)
    torch.cuda.empty_cache()
    tr = Trainer(args.model, cfg, seed=SEED, compute_dtype=torch.bfloat16, mesh=make_mesh(batch_size=cfg.batch_size))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(HYBRID_BF16_STEPS):
        begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        begin.record()
        tr.train_on_batch(imgs, labs)
        end.record()
        end.synchronize()
        times.append(begin.elapsed_time(end))
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    index = torch.cuda.current_device()
    out = {"rank": rank, "world": dist.get_world_size(), "backend": dist.get_backend(),
           "process": tr.mesh.process_index, "worker": tr.mesh.local_rank, "local_rank": int(os.environ["LOCAL_RANK"]),
           "device": str(tr.device), "cuda_index": index, "visible": visible,
           "card": int(visible.split(",")[index]) if visible else index, "name": torch.cuda.get_device_name(index),
           "train_s": train_s, "f32_launches": f32_launches, "launches": K.edge_weight_maps.launches, "calls": calls,
           "eval": [json.loads(ln) for ln in printed.getvalue().splitlines() if ln.startswith("{")],
           "bf16_ms": times, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    with open(os.path.join(root, f"{layout}_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def hybrid_cli(argv) -> int:
    """``chip_smoke.py --hybrid-cli ARGS``: ``bdt-train ARGS`` as shipped
    (its ``--local-devices`` launcher and all), with :func:`hybrid_body` in
    place of its body in the workers."""
    from building_detection_tpu_torch.cli import train as cli_train

    cli_train.train = hybrid_body
    return cli_train.main(argv)


def hybrid_lib(spec: dict) -> int:
    """``chip_smoke.py --hybrid-lib SPEC``: the launcher's library form over
    Gloo workers sharing the cards (worker ``k`` on card ``k % cards``),
    running :func:`hybrid_body` on ``bdt-train``'s arguments."""
    from building_detection_tpu_torch.cli import train as cli_train
    from building_detection_tpu_torch.parallel.launch import launch

    args = cli_train.build_parser().parse_args(spec["argv"] + ["--num-processes", "0"])
    launch(hybrid_body, args, local_devices=spec["local"], coordinator=spec["coordinator"],
           num_processes=spec["processes"], process_id=spec["pid"], backend="gloo", device_type="cuda")
    return 0


def phase_hybrid(here: str, work: str, smi: str) -> tuple:
    """Every local card of each process (``parallel/launch.py``): res34
    through ``bdt-train``'s body, 128^2, global batch 8, 2 f32 steps (TF32
    off), (a) two launcher processes of two workers against (b) one of
    four, then ``bdt-eval``'s body on (a)'s checkpoint in both layouts and
    bf16 steps a rank.  With four cards or more, the shipped CLI over NCCL:
    (a) ``--coordinator ... --num-processes 2 --process-id i --local-devices
    2`` on cards 0,1 and 2,3, (b) no process flags over the four cards (the
    JAX default, ``gcd(8, 4) = 4`` workers); with fewer, the library form
    over Gloo workers sharing the cards (NCCL refuses more workers than
    cards).  Returns the edge-kernel launches of the workers and of the
    one-card comparison steps."""
    import numpy as np
    import torch
    from PIL import Image

    from building_detection_tpu_torch.core.config import TrainConfig
    from building_detection_tpu_torch.kernels import edge_weights as K
    from building_detection_tpu_torch.parallel import dryrun
    from building_detection_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    me, env = os.path.abspath(__file__), port_env(here)
    cards = torch.cuda.device_count()
    for sub in ("img", "lab"):
        os.makedirs(os.path.join(work, sub))
    for i in range(HYBRID_SAMPLES):
        img, lab = train_batch(SEED + 80 + i, 1, HYBRID_PX)
        Image.fromarray(img[0]).save(os.path.join(work, "img", f"{i:02d}.png"))
        Image.fromarray(lab[0]).save(os.path.join(work, "lab", f"{i:02d}.png"))
    base = [HYBRID_MEMBER, "--train-images", os.path.join(work, "img"), "--train-labels", os.path.join(work, "lab"),
            "--batch-size", "8", "--epochs", "1", "--warmup-epochs", "0", "--image-size", str(HYBRID_PX),
            "--precision", "f32", "--device", "cuda"]
    port = dryrun.free_port()
    if cards >= 4:
        form = "bdt-train over NCCL, one card a worker"
        legs = {
            "a": [["env", f"CUDA_VISIBLE_DEVICES={p * 2},{p * 2 + 1}", sys.executable, me, "--hybrid-cli", *base,
                   "--checkpoint-dir", os.path.join(work, "a"), "--coordinator", f"127.0.0.1:{port}",
                   "--num-processes", "2", "--process-id", str(p), "--local-devices", "2"] for p in range(2)],
            "b": [["env", "CUDA_VISIBLE_DEVICES=0,1,2,3", sys.executable, me, "--hybrid-cli", *base,
                   "--checkpoint-dir", os.path.join(work, "b")]],
        }
    else:
        form = f"the library form over Gloo, the workers sharing {cards} card(s)"

        def lib(layout, local, processes, pid, coordinator):
            spec = {"argv": base + ["--checkpoint-dir", os.path.join(work, layout)], "local": local,
                    "processes": processes, "pid": pid, "coordinator": coordinator}
            return [sys.executable, me, "--hybrid-lib", json.dumps(spec)]

        legs = {"a": [lib("a", 2, 2, p, f"127.0.0.1:{port}") for p in range(2)], "b": [lib("b", 4, 1, 0, None)]}
    ranks, secs = {}, {}
    for layout in ("a", "b"):
        start = time.perf_counter()
        runs = dryrun.run_processes(legs[layout], env, HYBRID_TIMEOUT_S, cwd=here)
        secs[layout] = time.perf_counter() - start
        for i, (rc, text) in enumerate(runs):
            check(rc == 0, f"[hybrid] ({layout}) launcher process {i} exited {rc}: {text[-4000:]}")
        ranks[layout] = []
        for r in range(4):
            with open(os.path.join(work, f"{layout}_rank{r}.json")) as f:
                ranks[layout].append(json.load(f))

    for layout, what in (("a", "two launcher processes x 2 workers"), ("b", "one launcher process x 4 workers")):
        for info in ranks[layout]:
            say("hybrid", f"({layout}) {what}: rank {info['rank']} of {info['world']} ({info['backend']}) = process "
                          f"{info['process']} worker {info['worker']} on {info['device']} (CUDA_VISIBLE_DEVICES="
                          f"{info['visible']}, card {info['card']}, {info['name']})")
            check(info["rank"] == 2 * info["process"] + info["worker"] if layout == "a" else info["worker"] == info["rank"],
                  f"[hybrid] ({layout}) rank {info['rank']} is process {info['process']} worker {info['worker']}")
    # (a) against (b): the history's loss and the checkpoint's params
    losses = {}
    for layout in ("a", "b"):
        with open(os.path.join(work, layout, "history.json")) as f:
            losses[layout] = json.load(f)[-1]["loss"]
    rel = abs(losses["a"] - losses["b"]) / abs(losses["b"])
    with np.load(os.path.join(work, "a", "epoch_1_weights.npz")) as za, \
            np.load(os.path.join(work, "b", "epoch_1_weights.npz")) as zb:
        check(sorted(za.files) == sorted(zb.files), "[hybrid] the two checkpoints hold other keys")
        params = [k for k in za.files if k.startswith("params||")]
        worst = max(float(np.max(np.abs(za[k] - zb[k]))) for k in params)
        bit_equal = all(np.array_equal(za[k], zb[k]) for k in za.files)
    say("hybrid", f"{HYBRID_MEMBER} {HYBRID_PX}x{HYBRID_PX}, global batch 8, 2 f32 steps (TF32 off), {form}: loss (a) "
                  f"{losses['a']!r}, (b) {losses['b']!r}, rel |d| {rel:.2e} (rtol {HYBRID_LOSS_RTOL}); checkpoint "
                  f"params max |d| {worst:.2e} (atol {HYBRID_PARAM_ATOL}); the two checkpoints "
                  f"{'bit-equal' if bit_equal else 'NOT bit-equal'} ({smi})")
    check(rel <= HYBRID_LOSS_RTOL, f"[hybrid] (a) and (b) losses differ by rel {rel}")
    check(worst <= HYBRID_PARAM_ATOL, f"[hybrid] (a) and (b) params differ by {worst}")
    # the edge kernel on every rank, every step
    launches = 0
    for layout in ("a", "b"):
        for info in ranks[layout]:
            calls = info["calls"]
            check(calls and all(c["equal"] and c["launches"] == 1 and c["shape"] == [2, HYBRID_PX, HYBRID_PX]
                                for c in calls) and info["launches"] == len(calls),
                  f"[hybrid] ({layout}) rank {info['rank']}: edge kernel calls {calls}, launches {info['launches']}")
            launches += info["launches"]
    say("hybrid", f"edge kernel bit-equal to its twin on every rank's (2, {HYBRID_PX}, {HYBRID_PX}) labels at each of "
                  f"its {len(ranks['a'][0]['calls'])} calls a rank (2 training steps, 2 evaluation batches, "
                  f"{HYBRID_BF16_STEPS} bf16 steps), one launch each: {launches} launches over the 8 workers")
    # (c) bdt-eval's body on (a)'s checkpoint, both ways: one line, from rank 0, the same metrics
    evals = {layout: [info["eval"] for info in ranks[layout]] for layout in ("a", "b")}
    for layout in ("a", "b"):
        check(len(evals[layout][0]) == 1 and not any(evals[layout][1:]),
              f"[hybrid] ({layout}) bdt-eval printed {[len(e) for e in evals[layout]]} lines by rank, not one from rank 0")
    (ea,), (eb,) = evals["a"][0], evals["b"][0]
    eval_rel = abs(ea["loss"] - eb["loss"]) / abs(eb["loss"])
    say("hybrid", f"(c) bdt-eval of (a)'s checkpoint, f32: (a) {json.dumps(ea)}; (b) {json.dumps(eb)}; loss rel |d| "
                  f"{eval_rel:.2e}")
    check(sorted(ea) == sorted(eb) and all(ea[k] == eb[k] for k in ea if k != "loss") and eval_rel <= 1e-6,
          "[hybrid] (c) the metrics of the two layouts differ")
    # bf16 steps: a rank of (a), of (b), and one card alone
    cfg = TrainConfig(batch_size=8, image_size=HYBRID_PX, warmup_epochs=0)
    imgs, labs = train_batch(SEED + 70, cfg.batch_size, cfg.image_size)
    torch.cuda.empty_cache()
    before = K.edge_weight_maps.launches
    single = Trainer(HYBRID_MEMBER, cfg, seed=SEED, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(HYBRID_BF16_STEPS):
        begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        begin.record()
        single.train_on_batch(imgs, labs)
        end.record()
        end.synchronize()
        times.append(begin.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated() / 2**30
    plain_launches = K.edge_weight_maps.launches - before
    del single
    torch.cuda.empty_cache()
    for layout in ("a", "b"):
        say("hybrid", f"({layout}) {HYBRID_MEMBER} bf16 {HYBRID_PX}x{HYBRID_PX}, 2 rows a rank: step " + "; ".join(
            f"rank {i['rank']} " + " / ".join(f"{ms:.1f}" for ms in i["bf16_ms"]) + f" ms, peak {i['peak_gib']:.3f} GiB"
            for i in ranks[layout]) + f" (CUDA events, the first warms up); bdt-train's body "
            + " / ".join(f"{i['train_s']:.1f}" for i in ranks[layout])
            + f" s a rank, launcher wall {secs[layout]:.1f} s ({smi})")
    say("hybrid", f"one card alone, batch 8: step " + " / ".join(f"{ms:.1f}" for ms in times)
                  + f" ms, peak {peak:.3f} GiB; phase {time.perf_counter() - t0:.1f} s ({smi})")
    return launches, plain_launches


def tile_procs_layouts(cards: int) -> dict:
    """``{label: (data, model, tp)}`` of the ``[tile_procs]`` meshes."""
    if cards >= 4:
        return {"data=4": (4, 1, False), "data=2 x model=2, tp": (2, 2, True), "data=1 x model=4, tp": (1, 4, True)}
    return {"data=2": (2, 1, False), "data=1 x model=2, tp": (1, 2, True)}


def tile_procs_batch(data: int) -> int:
    """A data row's ``batch_tiles`` in the f32 checks.  Over several data
    rows chunks of 8 tiles, so every tile of the 9- and 8-tile scenes meets
    a forward of ``8 // data`` tiles, as in the one-process predictor at
    that ``batch_tiles``; at ``data=1`` (TP alone) a chunk holds a whole
    scene, since every chunk pays the sharded layers' gathers (261 in
    v3plus), which pace TP over Gloo."""
    return 16 if data == 1 else 8 // data


def tile_procs_scenes():
    """(the f32 scenes, the bf16 timing scenes), the same on every rank."""
    import numpy as np

    rng = np.random.RandomState(SEED + 90)
    f32 = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for h, w in TILE_DP_SCENES]
    rate = [rng.randint(0, 256, (TP_SCENE, TP_SCENE, 3)).astype(np.uint8) for _ in range(TILE_PROCS_RATE_SCENES)]
    return f32, rate


def tile_procs_body(spec: dict) -> int:
    """One launched worker of ``[tile_procs]``: v3plus through
    ``TiledPredictor`` over ``make_mesh(data, model)`` of every rank, for
    each layout of the spec, in f32 (TF32 off, deterministic cuDNN) on the
    f32 scenes and in bf16 on the timing scenes (host clock around
    ``predict_mask``, which waits for the mask; peak memory of this
    process's card).  Writes ``rank<r>.npz`` (the masks) and
    ``rank<r>.json`` into the spec's directory."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from building_detection_tpu_torch.core.config import TilerConfig
    from building_detection_tpu_torch.infer.engine import TiledPredictor
    from building_detection_tpu_torch.infer.fused_ensemble import DEFAULT_BATCH_TILES
    from building_detection_tpu_torch.models.registry import init_model
    from building_detection_tpu_torch.parallel.mesh import make_mesh

    rank = dist.get_rank()
    begun = time.perf_counter()
    base = init_model(TP_INFER_MEMBER, torch.Generator().manual_seed(SEED + 50))
    f32_scenes, rate_scenes = tile_procs_scenes()
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    index = torch.cuda.current_device()
    out = {"rank": rank, "world": dist.get_world_size(), "backend": dist.get_backend(), "visible": visible,
           "card": int(visible.split(",")[index]) if visible else index, "name": torch.cuda.get_device_name(index),
           "init_s": time.perf_counter() - begun, "layouts": {}}
    masks = {}
    for label, (data, model, tp) in spec["layouts"].items():
        mesh = make_mesh(data=data, model=model)
        saved = exact_f32()
        start = time.perf_counter()
        try:
            pred = TiledPredictor(copy.deepcopy(base), TilerConfig(), tile_procs_batch(data), torch.float32, mesh=mesh,
                                  tp=tp)
            for i, img in enumerate(f32_scenes):
                masks[f"{label}|f32|{i}"] = pred.predict_mask(img)
        finally:
            restore_backends(saved)
        f32_s = time.perf_counter() - start
        del pred
        torch.cuda.empty_cache()
        pred = TiledPredictor(copy.deepcopy(base), TilerConfig(), DEFAULT_BATCH_TILES // data, torch.bfloat16,
                              mesh=mesh, tp=tp)
        start = time.perf_counter()
        pred.predict_mask(rate_scenes[0])  # warm-up
        warm_s = time.perf_counter() - start
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        for i, img in enumerate(rate_scenes):
            masks[f"{label}|bf16|{i}"] = pred.predict_mask(img)
        secs = time.perf_counter() - start
        out["layouts"][label] = {
            "device": str(pred.device), "data_index": mesh.data_index, "model_index": mesh.model_index,
            "tp": pred.tp, "batch_tiles": pred.batch_tiles,
            "sharded": sum(1 for m in pred.model.modules() for _ in (getattr(m, "tp", None) or {})),
            "tiles_per_s": scene_tiles(rate_scenes, TilerConfig()) / secs,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "f32_s": f32_s, "warm_s": warm_s, "bf16_s": secs,
        }
        del pred
        torch.cuda.empty_cache()
    np.savez(os.path.join(spec["work"], f"rank{rank}.npz"), **masks)
    with open(os.path.join(spec["work"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def tile_procs_launcher(spec: dict) -> int:
    """``chip_smoke.py --tile-procs SPEC``: one launcher process of
    ``[tile_procs]``, two workers running :func:`tile_procs_body`."""
    from building_detection_tpu_torch.parallel.launch import launch

    launch(tile_procs_body, spec, local_devices=2, coordinator=spec["coordinator"], num_processes=spec["processes"],
           process_id=spec["pid"], backend=spec["backend"], device_type="cuda")
    return 0


def phase_tile_procs(here: str, work: str, smi: str) -> None:
    """The per-model predictor over a mesh that spans processes: v3plus
    through ``TiledPredictor`` in launched workers (:func:`tile_procs_body`),
    on one card two Gloo workers sharing it, on four cards or more two
    launchers of two NCCL workers; held in f32 against the one-process
    predictor here (tile data parallelism bit-equal at the same per-tile
    forward batch, TP within ``TP_PIXEL_FRAC`` of the pixels), every rank
    bit-equal to rank 0; bf16 tiles/s and peak memory a rank against one
    process on one card."""
    import numpy as np
    import torch

    from building_detection_tpu_torch.core.config import TilerConfig
    from building_detection_tpu_torch.infer.engine import TiledPredictor
    from building_detection_tpu_torch.infer.fused_ensemble import DEFAULT_BATCH_TILES
    from building_detection_tpu_torch.models.registry import init_model
    from building_detection_tpu_torch.parallel import dryrun

    t0 = time.perf_counter()
    me, env = os.path.abspath(__file__), port_env(here)
    cards = torch.cuda.device_count()
    layouts = tile_procs_layouts(cards)
    spec = {"layouts": layouts, "work": work}
    if cards >= 4:
        form = "two launcher processes of two NCCL workers, on cards 0,1 and 2,3"
        port = dryrun.free_port()
        argvs = [["env", f"CUDA_VISIBLE_DEVICES={2 * p},{2 * p + 1}", sys.executable, me, "--tile-procs",
                  json.dumps({**spec, "backend": "nccl", "processes": 2, "pid": p,
                              "coordinator": f"127.0.0.1:{port}"})] for p in range(2)]
    else:
        form = "one launcher process of two Gloo workers sharing cuda:0"
        argvs = [[sys.executable, me, "--tile-procs",
                  json.dumps({**spec, "backend": "gloo", "processes": 1, "pid": 0, "coordinator": None})]]
    runs = dryrun.run_processes(argvs, env, TILE_PROCS_TIMEOUT_S, cwd=here)
    launch_s = time.perf_counter() - t0
    for i, (rc, text) in enumerate(runs):
        check(rc == 0, f"[tile_procs] launcher process {i} exited {rc}: {text[-4000:]}")
    world = 4 if cards >= 4 else 2
    infos, masks = [], []
    for r in range(world):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            infos.append(json.load(f))
        with np.load(os.path.join(work, f"rank{r}.npz")) as z:
            masks.append({k: z[k] for k in z.files})
    for info in infos:
        check(info["world"] == world and info["card"] == (info["rank"] if cards >= 4 else 0),
              f"[tile_procs] rank {info['rank']} of {info['world']} sits on card {info['card']}")
        say("tile_procs", f"rank {info['rank']} of {info['world']} ({info['backend']}) on card {info['card']} "
                          f"(CUDA_VISIBLE_DEVICES={info['visible']}, {info['name']}): " + "; ".join(
                              f"{label}: data index {v['data_index']}, model index {v['model_index']}, "
                              f"{v['sharded']} sharded parameter groups, f32 checks {v['f32_s']:.1f} s, bf16 warm-up "
                              f"{v['warm_s']:.1f} s, timed {v['bf16_s']:.1f} s" for label, v in info["layouts"].items())
                          + f"; model built in {info['init_s']:.1f} s")
    for r in range(1, world):
        check(sorted(masks[r]) == sorted(masks[0]), f"[tile_procs] rank {r} returned other masks")
        differ = [k for k in masks[0] if not np.array_equal(masks[r][k], masks[0][k])]
        check(not differ, f"[tile_procs] rank {r}'s masks differ from rank 0's at {differ}")
    say("tile_procs", f"{form}: every rank's {len(masks[0])} masks bit-equal to rank 0's ({smi})")

    base = init_model(TP_INFER_MEMBER, torch.Generator().manual_seed(SEED + 50))
    cfg = TilerConfig()
    f32_scenes, rate_scenes = tile_procs_scenes()
    saved = exact_f32()
    try:
        want = {}
        for b in sorted({tile_procs_batch(data) for data, _, _ in layouts.values()}):
            single = TiledPredictor(copy.deepcopy(base), cfg, b, torch.float32)
            want[b] = [single.predict_mask(img) for img in f32_scenes]
            del single
    finally:
        restore_backends(saved)
    torch.cuda.empty_cache()
    for label, (data, model, tp) in layouts.items():
        b = tile_procs_batch(data)
        diffs = [int((masks[0][f"{label}|f32|{i}"] != w).sum()) for i, w in enumerate(want[b])]
        pixels = sum(w.size for w in want[b])
        fg = sum(int((w > 0).sum()) for w in want[b]) / pixels
        gate = f"at most {TP_PIXEL_FRAC * pixels:.0f}" if tp else "0"
        say("tile_procs", f"{TP_INFER_MEMBER} f32, TF32 off, deterministic cuDNN, {label} ({form}), batch_tiles={b} a "
                          f"data row, {TILE_DP_SCENES} scenes: {diffs} of {pixels} pixels differ from one process at "
                          f"batch_tiles={b} (gate {gate}; one process {fg:.1%} foreground) ({smi})")
        if tp:
            check(sum(diffs) <= TP_PIXEL_FRAC * pixels,
                  f"[tile_procs] f32 {label}: {diffs} pixels differ from one process")
        else:
            check(sum(diffs) == 0, f"[tile_procs] f32 {label}: {diffs} pixels differ from one process")

    single = TiledPredictor(copy.deepcopy(base), cfg, DEFAULT_BATCH_TILES, torch.bfloat16)
    single.predict_mask(rate_scenes[0])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    one = [single.predict_mask(img) for img in rate_scenes]
    tiles = scene_tiles(rate_scenes, cfg)
    rate = tiles / (time.perf_counter() - start)
    peak = torch.cuda.max_memory_allocated() / 2**30
    del single, base
    torch.cuda.empty_cache()
    result = {"form": form, "one_process": {"tiles_per_s": rate, "peak_gib": peak}, "layouts": {}}
    for label in layouts:
        diff = sum(int((masks[0][f"{label}|bf16|{i}"] != w).sum()) for i, w in enumerate(one))
        ranks = [info["layouts"][label] for info in infos]
        result["layouts"][label] = {"tiles_per_s": [v["tiles_per_s"] for v in ranks],
                                    "peak_gib": [v["peak_gib"] for v in ranks], "batch_tiles": ranks[0]["batch_tiles"],
                                    "pixels_differing_from_one_process": diff}
        per_rank = "; ".join(f"rank {r} {v['tiles_per_s']:.2f} tiles/s, peak {v['peak_gib']:.3f} GiB"
                             for r, v in enumerate(ranks))
        say("tile_procs", f"{TP_INFER_MEMBER} bf16 {label}: {tiles} tiles in {TILE_PROCS_RATE_SCENES} "
                          f"{TP_SCENE}x{TP_SCENE} scenes, batch_tiles={ranks[0]['batch_tiles']} a chunk: {per_rank}"
                          + f" (host clock after a warm-up scene); pixels differing from one process {diff} (not gated)"
                            f" ({smi})")
    say("tile_procs", f"one process on one card, bf16, batch_tiles={DEFAULT_BATCH_TILES}: {rate:.2f} tiles/s, peak "
                      f"{peak:.3f} GiB ({smi})")
    print(TILE_PROCS_RESULT + json.dumps(result), flush=True)
    say("tile_procs", f"launchers {launch_s:.1f} s, phase {time.perf_counter() - t0:.1f} s ({smi})")


def phase_tp_infer(smi: str) -> None:
    """Channel TP in inference: ``TiledPredictor(tp=True)`` over ``cuda:0``
    twice (``data=1 x model=2``), and on four cards also ``model=4`` and
    ``data=2 x model=2``, against the one-device predictor at the same
    ``batch_tiles``: f32 (TF32 off, deterministic cuDNN) differing pixels
    and softmax difference, gated; bf16 tiles/s and peak memory a device,
    and the host's enqueue time of one forward."""
    import numpy as np
    import torch

    from building_detection_tpu_torch.core.config import TilerConfig
    from building_detection_tpu_torch.infer.engine import TiledPredictor
    from building_detection_tpu_torch.infer.fused_ensemble import DEFAULT_BATCH_TILES
    from building_detection_tpu_torch.models.registry import init_model
    from building_detection_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    cards = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    meshes = {"cuda:0 twice, data=1 x model=2": make_mesh(devices=["cuda:0", "cuda:0"], data=1, model=2)}
    if len(cards) >= 4:
        meshes["cuda:0..3, data=1 x model=4"] = make_mesh(devices=cards[:4], data=1, model=4)
        meshes["cuda:0..3, data=2 x model=2"] = make_mesh(devices=cards[:4], data=2, model=2)
    base = init_model(TP_INFER_MEMBER, torch.Generator().manual_seed(SEED + 50))
    rng = np.random.RandomState(SEED + 50)
    scene = rng.randint(0, 256, (TP_SCENE, TP_SCENE, 3)).astype(np.uint8)
    cfg, b = TilerConfig(), DEFAULT_BATCH_TILES

    def predictor(dtype, mesh=None):
        if mesh is None:
            return TiledPredictor(copy.deepcopy(base), cfg, b, dtype)
        return TiledPredictor(copy.deepcopy(base), cfg, b // mesh.data, dtype, mesh=mesh, tp=True)

    saved = exact_f32()
    try:
        single = predictor(torch.float32)
        want = single.predict_mask(scene)
        tiles = torch.rand((9, 512, 512, 3), device="cuda", generator=torch.Generator("cuda").manual_seed(SEED)) * 2 - 1
        with torch.inference_mode():
            p_want = single.model(tiles)
        for label, mesh in meshes.items():
            tp = predictor(torch.float32, mesh)
            check(tp.tp and tp.batch_tiles == b, f"TiledPredictor(tp=True) on {label}: tp={tp.tp}, {tp.batch_tiles} tiles")
            got = tp.predict_mask(scene)
            with torch.inference_mode():
                p_err = float((tp.replicas[tp.device](tiles) - p_want).abs().max())
            diff = int((got != want).sum())
            sharded = sum(1 for m in tp.replicas[tp.device].modules() for _ in (getattr(m, "tp", None) or {}))
            say("tp", f"{TP_INFER_MEMBER} f32, TF32 off, deterministic cuDNN, TiledPredictor(tp=True) on {label} "
                      f"({sharded} sharded parameter groups) against one device at batch_tiles={b}: {diff} of "
                      f"{got.size} pixels of a {TP_SCENE}x{TP_SCENE} scene differ (gate {TP_PIXEL_FRAC * got.size:.0f}); "
                      f"softmax of 9 tiles within {p_err:.3e} (gate {TP_PROB_ATOL}) ({smi})")
            check(diff <= TP_PIXEL_FRAC * got.size, f"f32 TP on {label}: {diff} pixels differ from one device")
            check(p_err <= TP_PROB_ATOL, f"f32 TP on {label}: softmax differs by {p_err}")
            del tp
        del single, tiles, p_want
    finally:
        restore_backends(saved)
    torch.cuda.empty_cache()

    runs = {"one device": predictor(torch.bfloat16)}
    runs.update({label: predictor(torch.bfloat16, mesh) for label, mesh in meshes.items()})
    devices = {"one device": ["cuda:0"], **{label: list(dict.fromkeys(map(str, m.devices))) for label, m in meshes.items()}}
    scenes_bf16 = [rng.randint(0, 256, (TP_SCENE, TP_SCENE, 3)).astype(np.uint8) for _ in range(TP_RATE_SCENES)]
    order, masks, rates = list(runs), {}, {}
    for label in order:
        runs[label].predict_mask(scenes_bf16[0])  # warm-up
    for label in order + order[::-1]:
        pred = runs[label]
        sync_all(devices[label])
        for d in devices[label]:
            torch.cuda.reset_peak_memory_stats(d)
        start = time.perf_counter()
        out = [pred.predict_mask(img) for img in scenes_bf16]
        secs = time.perf_counter() - start
        masks.setdefault(label, out)
        peaks = {d: round(torch.cuda.max_memory_allocated(d) / 2**30, 3) for d in devices[label]}
        rates.setdefault(label, []).append(f"{9 * TP_RATE_SCENES / secs:.2f} tiles/s, peak {json.dumps(peaks)} GiB")
    with torch.inference_mode():
        x = (torch.rand((9, 512, 512, 3), device="cuda") * 2 - 1).to(torch.bfloat16)
        for label in order:
            pred = runs[label]
            forward = pred.replicas[pred.device]
            forward(x)
            sync_all(devices[label])
            start = time.perf_counter()
            forward(x)
            enqueued = time.perf_counter() - start
            sync_all(devices[label])
            done = time.perf_counter() - start
            diff = sum(int((a != w).sum()) for a, w in zip(masks[label], masks["one device"]))
            say("tp", f"{TP_INFER_MEMBER} bf16 {label}: {9 * TP_RATE_SCENES} tiles in {TP_RATE_SCENES} "
                      f"{TP_SCENE}x{TP_SCENE} scenes, batch_tiles={b}: {'; '.join(rates[label])} (in turns "
                      f"{order + order[::-1]} after a warm-up; host clock); pixels differing from one device {diff}; "
                      f"one 9-tile forward enqueued in {enqueued * 1e3:.1f} ms, done after {done * 1e3:.1f} ms ({smi})")
    del runs, masks, base, x
    torch.cuda.empty_cache()
    say("tp", f"inference legs {time.perf_counter() - t0:.1f} s")


def tp_child(spec: dict) -> int:
    """One rank of a ``[tp]`` training leg (``chip_smoke.py --tp-child
    SPEC``): ``spec`` names the backend, ``data``, ``model``, the rank, the
    port and the output directory.  One f32 step (TF32 off) of
    ``Trainer(TP_TRAIN_MEMBER, tp=True)`` saved to ``step1.npz``, the edge
    kernel held bit-equal to its twin on this rank's labels, then bf16 steps
    timed.  Prints one ``tp result`` JSON line."""
    import numpy as np
    import torch

    from building_detection_tpu_torch.core.config import TrainConfig
    from building_detection_tpu_torch.kernels import edge_weights as K
    from building_detection_tpu_torch.parallel import collectives
    from building_detection_tpu_torch.parallel import distributed as pdist
    from building_detection_tpu_torch.parallel.mesh import data_rows, make_mesh
    from building_detection_tpu_torch.train.trainer import Trainer

    cfg = TrainConfig()  # the first step at the warmup lr 1e-5, as the JAX package's TP test steps
    imgs, labs = train_batch(SEED + 15, cfg.batch_size, cfg.image_size)
    world = spec["data"] * spec["model"]
    pdist.init_distributed(f"127.0.0.1:{spec['port']}", world, spec["rank"], backend=spec["backend"])
    launch = K.edge_weight_maps
    try:
        mesh = make_mesh(data=spec["data"], model=spec["model"])
        out = {"rank": mesh.rank, "data_index": mesh.data_index, "model_index": mesh.model_index}
        saved = exact_f32()
        try:
            tr = Trainer(TP_TRAIN_MEMBER, cfg, seed=SEED, mesh=mesh, tp=True)
            out["device"] = str(tr.device)
            launch.launches = 0
            for k in collectives.tp_counts:
                collectives.tp_counts[k] = 0
            torch.cuda.synchronize()
            start = time.perf_counter()
            out["loss"] = tr.train_on_batch(imgs, labs)["loss"]  # fetching the metrics waits for the step
            out["f32_ms"] = (time.perf_counter() - start) * 1e3
            out["f32_launches"], out["counts"] = launch.launches, dict(collectives.tp_counts)
            tr.save(os.path.join(spec["out"], "step1.npz"))
            tr._check_replicas()
            del tr
        finally:
            restore_backends(saved)
        rows = labs[data_rows(mesh, len(labs))]
        label = torch.from_numpy(rows).cuda().float() / 255.0
        got, want = K.edge_weight_maps(label), K.edge_weight_maps_plain(label)
        out["edge_equal"] = all(torch.equal(g, w) for g, w in zip(got, want))
        out["edge_shape"] = list(label.shape)
        torch.cuda.empty_cache()
        tr = Trainer(TP_TRAIN_MEMBER, cfg, seed=SEED, mesh=mesh, tp=True, compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before, times = launch.launches, []
        for _ in range(TP_STEPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            tr.train_on_batch(imgs, labs)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        out.update(bf16_ms=times, bf16_launches=launch.launches - before,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    finally:
        pdist.destroy()
    print(TP_RESULT + json.dumps(out), flush=True)
    return 0


def moment_error(opt, want_opt) -> tuple:
    """How far the Keras Adam moments after one step (``mu = 0.1 g``, ``nu =
    0.001 g**2``: the gradients, which the params after one step at the
    warmup lr cannot show) are from ``want_opt``, each of ``mu`` and ``nu``
    apart: ``(largest over tensors of max |d| / the tensor's largest
    moment, the same with TP_MOMENT_FLOOR * the largest moment of any
    tensor taken off |d| first)``.  The gate holds the second."""
    import numpy as np

    raw, past = 0.0, float("-inf")
    for attr in ("mu", "nu"):
        keys = [k for k in want_opt if k.startswith(f".{attr}[")]
        floor = TP_MOMENT_FLOOR * max(float(np.abs(want_opt[k]).max()) for k in keys)
        for k in keys:
            d, top = float(np.abs(opt[k] - want_opt[k]).max()), max(float(np.abs(want_opt[k]).max()), 1e-30)
            raw, past = max(raw, d / top), max(past, (d - floor) / top)
    return raw, past


def phase_tp_train(here: str, work: str, smi: str) -> tuple:
    """Channel TP in training: ``Trainer(tp=True)`` over two Gloo ranks on
    ``cuda:0`` (``data=1 x model=2``), and on four cards over NCCL at
    ``data=2 x model=2`` and ``data=1 x model=4``, each rank a child
    process; one f32 step against one process (loss rel ``DP_LOSS_RTOL``,
    params ``TP_PARAM_RTOL``/``TP_PARAM_ATOL``, Adam moments
    ``TP_MOMENT_RTOL``), bf16 step time and peak
    memory a rank.  Returns the edge-kernel launches of the TP steps and of
    the one-process comparison step."""
    import numpy as np
    import torch

    from building_detection_tpu_torch.core.config import TrainConfig
    from building_detection_tpu_torch.core.module import jax_variables
    from building_detection_tpu_torch.kernels import edge_weights as K
    from building_detection_tpu_torch.parallel import dryrun
    from building_detection_tpu_torch.train.checkpoint import load_variables
    from building_detection_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    me, env = os.path.abspath(__file__), port_env(here)
    legs = [("gloo", 1, 2)]
    if torch.cuda.device_count() >= 4:
        legs += [("nccl", 2, 2), ("nccl", 1, 4)]
    results = {}
    for backend, data, model in legs:
        out = os.path.join(work, f"{backend}_{data}x{model}")
        os.makedirs(out)
        port = dryrun.free_port()
        argvs = [[sys.executable, me, "--tp-child", json.dumps({"backend": backend, "data": data, "model": model,
                                                              "rank": r, "port": port, "out": out})]
                 for r in range(data * model)]
        runs = dryrun.run_processes(argvs, env, TP_TIMEOUT_S, cwd=here)
        ranks = []
        for i, (rc, text) in enumerate(runs):
            check(rc == 0, f"[tp] {backend} {data}x{model}: rank {i} exited {rc}: {text[-4000:]}")
            ranks.append(json.loads(next(ln for ln in text.splitlines() if ln.startswith(TP_RESULT))[len(TP_RESULT):]))
        results[backend, data, model] = (ranks, out)

    cfg = TrainConfig()
    imgs, labs = train_batch(SEED + 15, cfg.batch_size, cfg.image_size)
    saved = exact_f32()
    try:
        before = K.edge_weight_maps.launches
        single = Trainer(TP_TRAIN_MEMBER, cfg, seed=SEED)
        want = single.train_on_batch(imgs, labs)["loss"]
        want_params, want_state = jax_variables(single.model)
        want_opt = single.optimizer.jax_state()
        plain_launches = K.edge_weight_maps.launches - before
        del single
    finally:
        restore_backends(saved)
        torch.cuda.empty_cache()
    tp_launches = 0
    for (backend, data, model), (ranks, out) in results.items():
        label = f"{backend} data={data} x model={model}"
        params, state, opt, step, _ = load_variables(os.path.join(out, "step1.npz"))
        check(step == 1 and sorted(params) == sorted(want_params) and sorted(state) == sorted(want_state)
              and sorted(opt) == sorted(want_opt), f"[tp] {label}: the checkpoint holds other keys or step {step}")
        moment_raw, moment_err = moment_error(opt, want_opt)
        worst = max(float(np.max(np.abs(params[k] - w) - TP_PARAM_RTOL * np.abs(w))) for k, w in want_params.items())
        worst_state = max((float(np.max(np.abs(state[k] - w) - TRAIN_STATE_RTOL * np.abs(w)))
                           for k, w in want_state.items()), default=0.0)  # scse has no BatchNorm
        losses = [r["loss"] for r in ranks]
        rel = abs(losses[0] - want) / abs(want)
        counts = ranks[0]["counts"]
        step_ms = " / ".join(f"{r['f32_ms']:.1f}" for r in ranks)
        say("tp", f"{TP_TRAIN_MEMBER} 512x512 batch 8 Trainer(tp=True), {label}, ranks on "
                  f"{[r['device'] for r in ranks]}, f32, TF32 off, one step: loss {losses[0]!r} (all ranks "
                  f"{'equal' if len(set(losses)) == 1 else losses}), one process {want!r}, rel |d| {rel:.2e} (rtol "
                  f"{DP_LOSS_RTOL}); params after the step: max(|d| - {TP_PARAM_RTOL} |p|) = {worst:.2e} (atol "
                  f"{TP_PARAM_ATOL}); Adam moments (the gradients) max over tensors of max |d| / max |m| = "
                  f"{moment_raw:.2e}, of (max |d| - {TP_MOMENT_FLOOR} max |m| of any) / max |m| = {moment_err:.2e} "
                  f"(rtol {TP_MOMENT_RTOL}); BN moving statistics "
                  f"max(|d| - {TRAIN_STATE_RTOL} |s|) = {worst_state:.2e} "
                  f"(atol {TRAIN_STATE_ATOL}); the step took {step_ms} ms on the ranks (host clock, a first step); "
                  f"collectives a step on rank 0: {counts['gather_channels']} channel gathers, "
                  f"{counts['copy_to_model']} gradient all-reduces over the model group, "
                  f"{counts['bytes'] / 1e9:.3f} GB sent ({smi})")
        check(len(set(losses)) == 1, f"[tp] {label}: the ranks' losses differ: {losses}")
        check(rel <= DP_LOSS_RTOL, f"[tp] {label}: loss differs from one process by rel {rel}")
        check(worst <= TP_PARAM_ATOL, f"[tp] {label}: params differ from one process by {worst} past rtol")
        check(moment_err <= TP_MOMENT_RTOL, f"[tp] {label}: the Adam moments differ from one process by {moment_err}")
        check(worst_state <= TRAIN_STATE_ATOL, f"[tp] {label}: BN state differs from one process by {worst_state}")
        for r in ranks:
            check(r["edge_equal"], f"[tp] {label} rank {r['rank']}: the edge kernel differs from its twin")
            check(r["f32_launches"] == 1 and r["bf16_launches"] == TP_STEPS,
                  f"[tp] {label} rank {r['rank']}: edge-kernel launches {r['f32_launches']} + {r['bf16_launches']}")
            tp_launches += r["f32_launches"] + r["bf16_launches"]
        say("tp", f"{TP_TRAIN_MEMBER} bf16 {label}: step " + "; ".join(
            f"rank {r['rank']} " + " / ".join(f"{ms:.1f}" for ms in r["bf16_ms"]) + f" ms, peak {r['peak_gib']:.2f} GiB"
            for r in ranks) + f" (CUDA events; the first step warms up); edge kernel bit-equal to its twin on every "
                              f"rank's {ranks[0]['edge_shape']} labels, launched once a step on each ({smi})")
    say("tp", f"training legs {time.perf_counter() - t0:.1f} s")
    return tp_launches, plain_launches


def fill_holes_mask(size: int, seed: int):
    """A {0,1} uint8 mask of filled rectangles, some with holes, and one
    walled corridor (numpy only)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    m = np.zeros((size, size), np.uint8)
    for _ in range(60):
        y, x = rng.randint(0, size - 80, 2)
        h, w = rng.randint(20, 80, 2)
        m[y : y + h, x : x + w] = 1
        if rng.rand() < 0.5:
            m[y + h // 3 : y + 2 * h // 3, x + w // 3 : x + 2 * w // 3] = 0
    return m


def phase_morph(smi: str) -> None:
    """``ops/morphology.py::majority_vote`` and ``fill_holes`` on the card,
    bit-equal to the same functions on the CPU."""
    import numpy as np
    import torch

    from building_detection_tpu_torch.ops import morphology as morph

    rng = np.random.RandomState(SEED + 60)
    masks = torch.from_numpy((rng.rand(*MORPH_VOTE) < 0.5).astype(np.uint8))
    want = morph.majority_vote(masks)
    dev = masks.cuda()
    got = morph.majority_vote(dev)
    check(torch.equal(got.cpu(), want), "majority_vote on the card differs from the CPU")
    vote_ms = cuda_ms(lambda: morph.majority_vote(dev), 10)
    mask = torch.from_numpy(fill_holes_mask(MORPH_FILL, SEED + 61))
    want, steps = morph.fill_holes_counted(mask)
    dev = mask.cuda()
    got, steps_dev = morph.fill_holes_counted(dev)
    check(torch.equal(got.cpu(), want) and steps_dev == steps, "fill_holes on the card differs from the CPU")
    check(int(want.sum()) > int(mask.sum()), "fill_holes filled nothing")
    fill_ms = cuda_ms(lambda: morph.fill_holes(dev), 5)
    say("morph", f"majority_vote over {MORPH_VOTE} uint8 masks: bit-equal to the CPU, {vote_ms:.3f} ms; fill_holes on "
                 f"a {MORPH_FILL}x{MORPH_FILL} mask with holes: bit-equal to the CPU, {steps} grow steps "
                 f"({int(want.sum()) - int(mask.sum())} pixels filled), {fill_ms:.2f} ms (CUDA events, median; one "
                 f"host sync a step) ({smi})")


def device_rows(prof) -> list:
    """The device rows of a ``torch.profiler`` run (kernels, copies, sets):
    ``(name, count, device ms)``, longest first, less the device side of
    host annotations (the program's ``train.*`` spans), which carry the
    names of host events.  Two passes over the events: ``key_averages()``
    would also total the ~10^5 CPU events of a few train steps, which takes
    seconds."""
    from torch.autograd import DeviceType

    events = prof.events()
    host = {e.name for e in events if e.device_type != DeviceType.CUDA}
    rows = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and e.name not in host:
            count, ms = rows.get(e.name, (0, 0.0))
            rows[e.name] = (count + 1, ms + e.time_range.elapsed_us() / 1e3)
    return sorted(((k, c, ms) for k, (c, ms) in rows.items()), key=lambda r: -r[2])


def learn_profile(name: str, trace_dir: str, smi: str) -> int:
    """One member at the learn recipe's size: LEARN_WARMUP_STEPS steps, then
    LEARN_PROFILE_STEPS timed by CUDA events, then as many under
    ``device_trace``; prints device ops and ms a step and the busy share.
    Returns the edge-kernel launches."""
    import numpy as np
    import torch

    from building_detection_tpu_torch.kernels import edge_weights as K
    from building_detection_tpu_torch.train import learn_smoke as LS
    from building_detection_tpu_torch.train.trainer import Trainer
    from building_detection_tpu_torch.utils.profiling import device_trace

    steps, hw, lr = LS.RECIPES[name]
    tr = Trainer(name, LS.learn_config(hw, lr), steps_per_epoch=steps, compute_dtype=torch.bfloat16)
    imgs, labs = (torch.from_numpy(a).cuda() for a in LS.make_dataset(np.random.RandomState(SEED + 70), LS.BATCH, hw))
    before = K.edge_weight_maps.launches
    for _ in range(LEARN_WARMUP_STEPS):
        tr.train_on_batch(imgs, labs, fetch_metrics=False)
    times = []
    for _ in range(LEARN_PROFILE_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        tr.train_on_batch(imgs, labs, fetch_metrics=False)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    with device_trace(trace_dir) as prof:
        for _ in range(LEARN_PROFILE_STEPS):
            tr.train_on_batch(imgs, labs, fetch_metrics=False)
    rows = device_rows(prof)
    check(bool(rows), f"[learn] {name}: the profiler saw no device time")
    launched = K.edge_weight_maps.launches - before
    check(launched == LEARN_WARMUP_STEPS + 2 * LEARN_PROFILE_STEPS, f"[learn] {name}: {launched} edge-kernel launches")
    ops = sum(r[1] for r in rows) / LEARN_PROFILE_STEPS
    dev_ms = sum(r[2] for r in rows) / LEARN_PROFILE_STEPS
    step_ms = statistics.median(times)
    top = "; ".join(f"{k[:60]} {100 * ms / LEARN_PROFILE_STEPS / dev_ms:.1f} %" for k, _, ms in rows[:3])
    say("learn", f"{name} profile at {hw}x{hw}, batch {LS.BATCH}, bf16: {ops:.0f} device ops a step (kernels, copies, "
                 f"sets), {dev_ms:.2f} device ms a step (device_trace over {LEARN_PROFILE_STEPS} steps); step "
                 f"{step_ms:.2f} ms unprofiled (CUDA events, median of {LEARN_PROFILE_STEPS}), busy "
                 f"{100 * dev_ms / step_ms:.1f} %; longest: {top} ({smi})")
    del tr
    torch.cuda.empty_cache()
    return launched


def learn_child(name: str) -> int:
    """One member of the ``[learn]`` phase (``chip_smoke.py --learn-child
    NAME``): trains it by the recipe of ``train/learn_smoke.py`` on the card,
    prints the smoke's lines, then one ``learn result`` JSON line with its
    edge-kernel launches."""
    from building_detection_tpu_torch.kernels import edge_weights as K
    from building_detection_tpu_torch.train import learn_smoke as LS

    before = K.edge_weight_maps.launches
    r = LS.run_one(name, log=lambda line: print(line.strip(), flush=True))
    print(LEARN_RESULT + json.dumps({**r, "passed": bool(r["passed"]),
                                     "launches": K.edge_weight_maps.launches - before}), flush=True)
    return 0


def phase_learn(here: str, smi: str) -> int:
    """Every member learns by the recipe of ``train/learn_smoke.py`` on the
    card (held-out IoU > 0.5), the five side by side, each in a process of
    its own (the steps are host-paced, so a member's host time is its own);
    then the 128^2 profile of each, one at a time.  Returns the edge-kernel
    launches: one a step, two for the held-out batch (eval mode, and BN on
    the batch's own statistics)."""
    import tempfile

    import torch

    from building_detection_tpu_torch.parallel import dryrun
    from building_detection_tpu_torch.train import learn_smoke as LS

    t0 = time.perf_counter()
    me = os.path.abspath(__file__)
    runs = dryrun.run_processes([[sys.executable, me, "--learn-child", name] for name in LS.RECIPES],
                                port_env(here), LEARN_TIMEOUT_S, cwd=here)
    launches = 0
    for (name, (steps, hw, lr)), (rc, text) in zip(LS.RECIPES.items(), runs):
        check(rc == 0, f"[learn] {name}: its process exited {rc}: {text[-4000:]}")
        lines = text.splitlines()
        for line in lines:
            if not line.startswith(LEARN_RESULT):
                say("learn", line.strip())
        r = json.loads(next(ln for ln in lines if ln.startswith(LEARN_RESULT))[len(LEARN_RESULT):])
        launched = r["launches"]
        say("learn", f"{name}: held-out IoU {r['IoU']:.4f} PA {r['PA']:.4f} F1 {r['F1_score']:.4f} (gate IoU > "
                     f"{LS.IOU_GATE}), {r['batch_stats_IoU']:.4f} with the batch's own BN statistics; last train "
                     f"loss {r['train_loss']:.4f}, IoU {r['train_IoU']:.4f}; seed {r['seed']}, {r['steps']} "
                     f"{r['dtype']} steps at {hw}x{hw}, "
                     f"lr {lr}, in {r['seconds']:.1f} s, {r['step_ms']:.2f} ms a step (host clock, chunks after "
                     f"the first, the five members side by side); edge-kernel launches {launched} ({smi})")
        check(math.isfinite(r["train_loss"]), f"[learn] {name}: non-finite loss")
        check(r["IoU"] > LS.IOU_GATE, f"[learn] {name} did not learn: held-out IoU {r['IoU']:.4f}")
        check(launched == steps + 2, f"[learn] {name}: {launched} edge-kernel launches in {steps} steps and two "
                                     "held-out evaluations")
        launches += launched
    learn_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(dir=here) as trace_dir:
        for name in LS.RECIPES:
            launches += learn_profile(name, trace_dir, smi)
        traces = os.listdir(trace_dir)
        check(len(traces) == len(LS.RECIPES), f"[learn] device_trace wrote {traces}")
    torch.cuda.empty_cache()
    say("learn", f"all five learned in {learn_s:.1f} s side by side; profiles "
                 f"{time.perf_counter() - t0 - learn_s:.1f} s")
    return launches


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import torch

    from building_detection_tpu_torch.infer.pipeline import Pipeline

    t_start = time.perf_counter()
    kind, smi = phase_device()
    phase_build()
    edge = phase_edge_check()
    phase_normalize()
    phase_parity()
    pipe = Pipeline(compute_dtype=torch.bfloat16, seed=SEED)
    check(pipe.ensemble.device.type == "cuda", f"Pipeline() runs on {pipe.ensemble.device}, not the card")
    launches = phase_main_path(pipe)
    phase_serving(pipe)
    phase_engine(pipe)
    phase_blocked(pipe)
    eval_launches = phase_tile_dp(pipe, here, smi)
    phase_sweep(pipe)
    phase_int_mm()
    int_mm_calls = phase_int8(pipe)
    del pipe
    torch.cuda.empty_cache()
    import tempfile

    with tempfile.TemporaryDirectory(dir=here) as work:
        for phase in (phase_predict_cli, phase_serve_cli, phase_augment_cli):
            sub = os.path.join(work, phase.__name__)
            os.makedirs(sub)
            phase(here, sub)
        os.makedirs(os.path.join(work, "phase_h5"))
        phase_h5(here, os.path.join(work, "phase_h5"), smi)
    phase_train_parity()
    train_launches = phase_train_full()
    remat_launches = phase_remat()
    phase_train_resume_and_staged()
    learn_launches = phase_learn(here, smi)
    with tempfile.TemporaryDirectory(dir=here) as work:
        dp_launches, dp_plain_launches = phase_dp(here, work, smi)
    with tempfile.TemporaryDirectory(dir=here) as work:
        hybrid_launches, hybrid_plain_launches = phase_hybrid(here, work, smi)
    with tempfile.TemporaryDirectory(dir=here) as work:
        phase_tile_procs(here, work, smi)
    phase_tp_infer(smi)
    with tempfile.TemporaryDirectory(dir=here) as work:
        tp_launches, tp_plain_launches = phase_tp_train(here, work, smi)
    phase_morph(smi)
    serving_launches = launches["edge_weight_maps"]
    launches["edge_weight_maps"] += (train_launches + remat_launches + learn_launches + dp_launches
                                     + dp_plain_launches + eval_launches + tp_launches + tp_plain_launches
                                     + hybrid_launches + hybrid_plain_launches)
    say("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s; edge-kernel launches: serving path "
                f"{serving_launches}, training path {train_launches}, remat steps {remat_launches}, learning runs and "
                f"their profiles {learn_launches}, data-parallel "
                f"steps {dp_launches}, the [dp] phase's plain comparison steps {dp_plain_launches}, the [tile_dp] "
                f"phase's bdt-eval processes {eval_launches}, tensor-parallel steps {tp_launches}, the [tp] phase's "
                f"one-process comparison step {tp_plain_launches}, the [hybrid] phase's workers {hybrid_launches} "
                f"and its one-card comparison steps {hybrid_plain_launches}; torch._int_mm "
                f"launches on the int8 path {int_mm_calls}")
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
    if sys.argv[1:2] == ["--dp-child"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(dp_child(json.loads(sys.argv[2])))
    if sys.argv[1:2] == ["--tp-child"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(tp_child(json.loads(sys.argv[2])))
    if sys.argv[1:2] == ["--hybrid-cli"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(hybrid_cli(sys.argv[2:]))
    if sys.argv[1:2] == ["--hybrid-lib"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(hybrid_lib(json.loads(sys.argv[2])))
    if sys.argv[1:2] == ["--tile-procs"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(tile_procs_launcher(json.loads(sys.argv[2])))
    if sys.argv[1:2] == ["--enqueue-probe"]:
        sys.path.insert(0, os.getcwd())
        sys.exit(enqueue_probe())
    if sys.argv[1:2] == ["--h5-probe"]:
        sys.path.insert(0, os.getcwd())
        sys.exit(h5_probe())
    if sys.argv[1:2] == ["--learn-child"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(learn_child(sys.argv[2]))
    if sys.argv[1:2] == ["--exact-eval"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(exact_eval_child(sys.argv[2:]))
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"[chip_smoke] FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
