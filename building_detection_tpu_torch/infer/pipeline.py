"""Full prediction pipeline: image -> 5 masks -> fused mask -> polygons.

The counterpart of ``building_detection_tpu/infer/pipeline.py``.  The
device half is :class:`~building_detection_tpu_torch.infer.fused_ensemble.
FusedEnsemblePredictor` (or, with ``fused=False``, the per-model
:class:`~building_detection_tpu_torch.infer.engine.EnsemblePredictor`);
scenes over ``max_scene_tiles`` tiles go through the blocked path of
``infer/large_scene.py``.  Fusion and polygon extraction are the port's own
copies of the JAX package's host code (``post/fusion.py``,
``post/edges.py``).  Files appear only where the CLI contract asks for them
(:meth:`Pipeline.predict_file`).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from building_detection_tpu_torch.core.config import Config
from building_detection_tpu_torch.core.device import check_device
from building_detection_tpu_torch.core.module import load_jax_variables
from building_detection_tpu_torch.infer.engine import EnsemblePredictor
from building_detection_tpu_torch.infer.fused_ensemble import (
    DEFAULT_BATCH_TILES,
    FusedEnsemblePredictor,
)
from building_detection_tpu_torch.infer.large_scene import predict_masks_blocked
from building_detection_tpu_torch.models.registry import ENSEMBLE_ORDER, build_model, init_model
from building_detection_tpu_torch.ops import tiling as T
from building_detection_tpu_torch.post import edges as E
from building_detection_tpu_torch.post import fusion as F
from building_detection_tpu_torch.train.checkpoint import load_variables
from building_detection_tpu_torch.utils import io as uio
from building_detection_tpu_torch.utils.profiling import StageTimer


def discover_weights(weights_dir: str) -> Dict[str, str]:
    """Find per-model checkpoints in a directory: ``{name}.npz``, then
    ``{name}.h5`` and the reference deployment's own file names
    (``resnet34.h5`` for res34, ``deep.h5`` for v3plus).  First match wins."""
    aliases = {"res34": ("res34", "resnet34"), "v3plus": ("v3plus", "deep")}
    found: Dict[str, str] = {}
    for name in ENSEMBLE_ORDER:
        candidates = [f"{name}.npz"]
        for stem in aliases.get(name, (name,)):
            candidates += [f"{stem}.h5", f"{stem}.hdf5"]
        for fname in candidates:
            path = os.path.join(weights_dir, fname)
            if os.path.exists(path):
                found[name] = path
                break
    return found


@dataclasses.dataclass
class PredictResult:
    masks: Dict[str, np.ndarray]  # per-model {0,255} masks
    fused: np.ndarray             # fused {0,255} mask
    corners: List[List[list]]     # closed polygon rings [[xs, ys], ...]
    height: int


class Pipeline:
    """End-to-end detector with the members resident on ``device``: the
    card by default, and a CUDA device that is not there raises (nothing
    falls back to the CPU; pass ``device="cpu"`` to run there).

    ``weights`` maps model name -> ``.npz`` checkpoint in the JAX package's
    format; members without one get Keras-initialised weights from
    ``torch.Generator().manual_seed(seed + i)``.

    ``fused=True`` runs the members over shared tiles in one dispatch per
    scene group; ``fused=False`` runs each member through its own
    :class:`~building_detection_tpu_torch.infer.engine.TiledPredictor`.

    ``max_scene_tiles``: scenes whose tile grid exceeds it run through the
    blocked path (``infer/large_scene.py``), blocks of ``batch_tiles`` tiles,
    so the scene canvas on the device is O(block) and the masks are the
    whole-scene ones.  ``None`` turns blocking off.  Blocking needs the
    default ``fix_nonsquare_bug=True`` grid: a big scene in bug mode raises.

    Not ported, and refused with ``NotImplementedError``: ``.h5`` weights
    and ``int8_pointwise``.
    """

    def __init__(
        self,
        weights: Optional[Dict[str, str]] = None,
        cfg: Config = Config(),
        batch_tiles: int = DEFAULT_BATCH_TILES,
        compute_dtype: torch.dtype = torch.bfloat16,
        models: tuple = ENSEMBLE_ORDER,
        seed: int = 0,
        device="cuda",
        fused: bool = True,
        max_scene_tiles: Optional[int] = 1024,
        int8_pointwise: bool = False,
    ):
        if int8_pointwise:
            raise NotImplementedError("int8 pointwise convs are slice 3 of the port")
        device = torch.device(device)
        check_device(device)
        self.cfg = cfg
        self.batch_tiles = batch_tiles
        self.max_scene_tiles = max_scene_tiles
        weights = weights or {}
        members = {}
        for i, name in enumerate(models):
            path = weights.get(name)
            if path is None:
                print(f"[pipeline] no weights for {name!r}: using random init")
                members[name] = init_model(name, torch.Generator().manual_seed(seed + i))
            elif path.endswith((".h5", ".hdf5")):
                raise NotImplementedError(f"{path}: .h5 import is not ported; convert it to .npz with bdt-convert")
            else:
                params, state, *_ = load_variables(path)
                members[name] = load_jax_variables(build_model(name), params, state)
        # each member module goes to exactly one predictor, which owns it
        make = FusedEnsemblePredictor if fused else EnsemblePredictor
        self.ensemble = make(members, cfg.tiler, batch_tiles, compute_dtype, device)
        self.timer = StageTimer()

    def _needs_blocking(self, image_rgb: np.ndarray) -> bool:
        if self.max_scene_tiles is None:
            return False
        _, n_h = T._axis_tiles(image_rgb.shape[0], self.cfg.tiler)
        _, n_w = T._axis_tiles(image_rgb.shape[1], self.cfg.tiler)
        if not self.cfg.tiler.fix_nonsquare_bug:
            n_w = n_h
        return n_h * n_w > self.max_scene_tiles

    def _predict_masks(self, image_rgb: np.ndarray) -> Dict[str, np.ndarray]:
        if self._needs_blocking(image_rgb):
            return predict_masks_blocked(self.ensemble, image_rgb, max_block_tiles=self.batch_tiles)
        return self.ensemble.predict_masks(image_rgb)

    def _post(self, masks: Dict[str, np.ndarray]) -> PredictResult:
        # fused in glob (alphabetical) order, as the reference reads them
        with self.timer.stage("fusion"):
            fused = F.fuse_masks([masks[k] for k in sorted(masks)], self.cfg.fuse)
        with self.timer.stage("polygons"):
            corners, height = E.extract_polygons(fused, self.cfg.edge)
        return PredictResult(masks, fused, corners, height)

    def predict_image(self, image_rgb: np.ndarray) -> PredictResult:
        """RGB array in, polygons out; nothing touches the filesystem."""
        return self.predict_images([image_rgb])[0]

    def predict_images(self, images: List[np.ndarray]) -> List[PredictResult]:
        """Batch prediction, results in input order.  Over the fused
        predictor same-shape scenes share dispatches, and each fetched
        scene's host post-processing overlaps the remaining groups' device
        work; over the per-model engine scenes run one at a time.  Scenes
        over ``max_scene_tiles`` take the blocked path one at a time after
        the rest (each is pipelined over its blocks)."""
        results: List[Optional[PredictResult]] = [None] * len(images)
        big = [i for i, img in enumerate(images) if self._needs_blocking(img)]
        small = sorted(set(range(len(images))) - set(big))
        if hasattr(self.ensemble, "predict_masks_iter"):
            it = self.ensemble.predict_masks_iter([images[i] for i in small])
            while True:
                with self.timer.stage("ensemble_forward"):
                    try:
                        idx, masks = next(it)
                    except StopIteration:
                        break
                results[small[idx]] = self._post(masks)
        else:
            for i in small:
                with self.timer.stage("ensemble_forward"):
                    masks = self.ensemble.predict_masks(images[i])
                results[i] = self._post(masks)
        for i in big:
            with self.timer.stage("ensemble_forward"):
                masks = self._predict_masks(images[i])
            results[i] = self._post(masks)
        return results

    def predict_file(
        self,
        img_path: str,
        out_dir: str,
        name: Optional[str] = None,
        keep_intermediates: bool = False,
    ) -> PredictResult:
        """File-in / files-out contract of `predict.py:141-178`: writes
        ``{name}_result.png`` and ``{name}.txt`` into ``out_dir``, and the
        per-model ``{model}_{name}.png`` only with ``keep_intermediates``
        (the reference deletes them, `predict.py:174-178`)."""
        if name is None:
            name = os.path.splitext(os.path.basename(img_path))[0]
        os.makedirs(out_dir, exist_ok=True)
        result = self.predict_image(uio.imread_rgb(img_path))
        if keep_intermediates:
            for model_name, mask in result.masks.items():
                uio.imwrite(os.path.join(out_dir, f"{model_name}_{name}.png"), mask)
        uio.imwrite(os.path.join(out_dir, f"{name}_result.png"), result.fused)
        uio.write_points(result.corners, os.path.join(out_dir, f"{name}.txt"))
        return result
