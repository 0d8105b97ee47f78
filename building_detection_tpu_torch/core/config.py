"""Framework configuration: every hard-coded constant of the reference,
lifted into dataclasses (SURVEY.md section 2.4 "behavioral contract").

The port's own copy of ``building_detection_tpu/core/config.py``: the same
classes, fields and defaults, so a config written by either package reads
back in the other (``tests/test_torch_shared.py`` holds the two equal).
Each field cites where the reference hard-codes the value.  ``MeshConfig``
is kept as data; the port trains on one device.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class TilerConfig:
    """Sliding-window tiler geometry (`reference/predict.py:90-116`)."""

    tile: int = 512          # window size (`predict.py:102`)
    stride: int = 360        # window stride (`predict.py:105`)
    overlap: int = 152       # = tile - stride (`predict.py:98`)
    normalize_div: float = 127.5  # img/127.5 - 1 (`predict.py:93`)
    # The reference's inner loop iterates the width axis over new_h
    # (`predict.py:106`) which mis-tiles non-square scenes.  We fix it (the
    # fix is a no-op on the square WHU tiles used for parity; see
    # docs/QUIRKS.md).
    fix_nonsquare_bug: bool = True
    # Round scene canvases up to power-of-two tile grids so scenes of
    # arbitrary size share a handful of shapes (bit-identical output; some
    # padded compute).  See ops/tiling.bucket_plan.
    bucket_sizes: bool = False


@dataclasses.dataclass(frozen=True)
class FuseConfig:
    """Ensemble fusion (`reference/model_fuse.py`)."""

    vote_threshold: int = 3      # 3-of-5 majority (`model_fuse.py:323`)
    num_models: int = 5
    min_area: float = 1000.0     # delete areas <= this (`model_fuse.py:22`)
    fragment_min_area: float = 500.0  # post-erosion fragments (`model_fuse.py:57`)
    split_kernel: int = 5        # 1x5 / 5x1 erosion kernels (`model_fuse.py:180`)
    split_iterations: int = 5    # erosion iterations (`model_fuse.py:180-181`)


@dataclasses.dataclass(frozen=True)
class EdgeConfig:
    """Contour/polygon extraction (`reference/edge_3.py`)."""

    min_area: float = 100.0      # fill areas <= this (`edge_3.py:326`)
    split_kernel: int = 7        # 1x7 / 7x1 erosion (`edge_3.py:331`)
    split_iterations: int = 1
    erode_fragment_area: float = 50.0   # (`edge_3.py:128`)
    erode_ignore_area: float = 10.0     # (`edge_3.py:131`)
    bbox_iou_threshold: float = 0.5     # match pre/post erosion (`edge_3.py:42`)
    moment_min_m00: float = 10.0        # skip tiny moments (`edge_3.py:360`)
    # Polygon epsilon table by contour area (`edge_3.py:357-378`).  Note the
    # reference leaves a gap at 300-3000 and exactly 150/300/8000/15000,
    # which falls through to the default epsilon; preserved faithfully.
    small_area: float = 150.0           # -> small_target quadrilateral fit
    mid_area: float = 300.0             # 150<a<300 -> 5x epsilon
    big_areas: Tuple[float, float, float] = (3000.0, 8000.0, 15000.0)
    big_rates: Tuple[float, float, float] = (0.005, 0.004, 0.002)
    default_rate: float = 0.01          # eps = 0.01 * arcLength (`edge_3.py:357`)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training harness (`reference/train_model/res34.py`)."""

    batch_size: int = 8          # (`res34.py:572`)
    epochs: int = 30             # (`res34.py:574`)
    warmup_epochs: int = 3       # (`res34.py:576`)
    lr_base: float = 1e-3        # (`res34.py:579`)
    warmup_lr: float = 1e-5      # (`res34.py:581`)
    min_lr: float = 0.0
    loss: str = "edge_focal_loss"  # compiled loss (`res34.py:665`)
    class_weights: Tuple[float, float] = (0.35, 0.65)  # (`res34.py:349`)
    edge_weight: float = 2.0     # edge-band weight (`res34.py:91,99`)
    edge_kernel: int = 3         # 3x3 erode/dilate (`res34.py:82`)
    edge_iterations: int = 5     # x5 iterations (`res34.py:85,96`)
    image_size: int = 512
    num_classes: int = 2
    # (pos, neg) label smoothing; the reference sketches this but leaves it
    # dead (`res34.py:76-79`). None = off (reference behaviour).
    label_smooth: tuple = None


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Data augmentation (`reference/data_enhancement.py:62-131`)."""

    p_flip_ud: float = 0.8       # random.random() > 0.2 (`data_enhancement.py:73`)
    p_flip_lr: float = 0.8       # (`data_enhancement.py:80`)
    p_scale: float = 0.8         # (`data_enhancement.py:87`)
    p_color: float = 0.3         # BGR<->RGB swap (`data_enhancement.py:94`)
    scale_range: Tuple[float, float] = (0.6, 2.0)  # (`data_enhancement.py:88`)
    pad_value: int = 128         # gray pad when shrunk (`data_enhancement.py:112`)
    label_threshold: int = 125   # re-binarize labels (`data_enhancement.py:134`)
    split_rate: float = 0.9      # 9:1 train/val (`data_enhancement.py:171`)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """HTTP serving (`reference/buildAPI.py`)."""

    host: str = "0.0.0.0"
    port: int = 5001             # (`buildAPI.py:233`)
    receive_dir: str = "receive_file"
    result_dir: str = "all_result"
    # Hardening beyond the reference (which reads unbounded bodies with no
    # deadline, `buildAPI.py:104-109`): oversized uploads are rejected with
    # HTTP 413 BEFORE any body byte is read, and a request whose body hasn't
    # fully arrived within the deadline is dropped (slow-loris can't pin a
    # worker thread).  256 MB admits any realistic remote-sensing scene PNG
    # (a 16384x16384 RGB PNG is ~200 MB) with headroom.
    max_request_bytes: int = 256 * 1024 * 1024
    request_timeout_s: float = 120.0
    # SIGTERM graceful-drain bound: how long serve() waits for in-flight
    # requests before closing anyway (the reference's bare app.run kills
    # them on the spot, `buildAPI.py:233`).
    drain_timeout_s: float = 300.0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh for multi-chip execution (no reference equivalent; the
    reference is single-GPU, SURVEY.md section 2.3)."""

    data_axis: str = "data"      # tiles / batch sharding
    model_axis: str = "model"    # reserved for channel TP / ensemble groups
    data_parallel: int = -1      # -1 = all available devices


@dataclasses.dataclass(frozen=True)
class Config:
    tiler: TilerConfig = TilerConfig()
    fuse: FuseConfig = FuseConfig()
    edge: EdgeConfig = EdgeConfig()
    train: TrainConfig = TrainConfig()
    augment: AugmentConfig = AugmentConfig()
    serve: ServeConfig = ServeConfig()
    mesh: MeshConfig = MeshConfig()

    @staticmethod
    def from_json(path: str) -> "Config":
        with open(path) as f:
            raw = json.load(f)
        kw = {}
        for field in dataclasses.fields(Config):
            if field.name in raw:
                sub_cls = field.default.__class__
                # JSON has no tuples; coerce lists back so round-tripped
                # configs stay hashable and == their defaults
                vals = {
                    k: tuple(v) if isinstance(v, list) else v
                    for k, v in raw[field.name].items()
                }
                kw[field.name] = sub_cls(**vals)
        return Config(**kw)

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)


DEFAULT_CONFIG = Config()
