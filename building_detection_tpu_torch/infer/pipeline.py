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
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from building_detection_tpu_torch.core.config import Config
from building_detection_tpu_torch.core.module import calibrate_int8, jax_variables, load_jax_variables
from building_detection_tpu_torch.infer.engine import EnsemblePredictor
from building_detection_tpu_torch.infer.fused_ensemble import (
    DEFAULT_BATCH_TILES,
    FusedEnsemblePredictor,
    check_data_only,
)
from building_detection_tpu_torch.infer.large_scene import predict_masks_blocked
from building_detection_tpu_torch.models.registry import ENSEMBLE_ORDER, build_model, init_model
from building_detection_tpu_torch.ops import tiling as T
from building_detection_tpu_torch.parallel.mesh import predictor_devices
from building_detection_tpu_torch.post import edges as E
from building_detection_tpu_torch.post import fusion as F
from building_detection_tpu_torch.train.checkpoint import import_h5_weights, load_variables
from building_detection_tpu_torch.utils import io as uio
from building_detection_tpu_torch.utils.profiling import StageTimer


def _calibration_tiles(scenes: List[np.ndarray], cfg: Config, max_tiles: int) -> np.ndarray:
    """``(N, tile, tile, 3)`` uint8 calibration tiles cut from RGB scenes
    with the inference tiler's geometry (`predict.py:98-106`)."""
    tile = cfg.tiler.tile
    out: List[np.ndarray] = []
    for img in scenes:
        h, w = img.shape[:2]
        plan = T.plan_tiles(h, w, cfg.tiler)
        canvas = np.zeros((plan.canvas_h, plan.canvas_w, 3), np.uint8)
        canvas[:h, :w] = img
        for oy, ox in plan.origins:
            out.append(canvas[oy : oy + tile, ox : ox + tile])
            if len(out) >= max_tiles:
                return np.stack(out)
    if not out:
        raise ValueError("int8 calibration needs at least one scene")
    return np.stack(out)


def calibrate_members_int8(
    members: Dict[str, torch.nn.Module],
    scenes: List[np.ndarray],
    cfg: Config = Config(),
    compute_dtype: torch.dtype = torch.bfloat16,
    int8_pointwise=True,
    max_tiles: int = 32,
    chunk: int = 8,
) -> Dict[str, Dict[str, float]]:
    """``{member: {site: amax}}`` over tiles of representative scenes, for
    the predictors' ``int8_scales`` (the JAX function of the same name).

    Tiles are cut and normalized to ``compute_dtype`` as inference does, in
    chunks of ``chunk`` (the last padded by repeating the first tiles), and
    go through each eval-mode member on its own device; the members should
    compute in ``compute_dtype`` (as the predictors leave them).
    ``int8_pointwise`` must be the inference flag, so the calibrated sites
    are the active ones.
    """
    tiles = _calibration_tiles(scenes, cfg, max_tiles)
    n = tiles.shape[0]
    chunk = min(chunk, n)
    pad = (-n) % chunk
    if pad:
        tiles = np.concatenate([tiles, tiles[:pad]], axis=0)
    scales: Dict[str, Dict[str, float]] = {}
    for name, model in members.items():
        device = next(model.parameters()).device
        batches = (
            T.normalize(torch.from_numpy(tiles[i : i + chunk]).to(device), cfg.tiler, dtype=compute_dtype)
            for i in range(0, tiles.shape[0], chunk)
        )
        scales[name] = calibrate_int8(model.eval(), batches, int8_pointwise=int8_pointwise)
    return scales


def save_int8_scales(path: str, scales: Dict[str, Dict[str, float]]) -> None:
    """Write calibration scales as JSON (calibrate once, serve with the
    file); the JAX package reads and writes the same file."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(scales, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def load_int8_scales(path: str) -> Dict[str, Dict[str, float]]:
    with open(path) as f:
        scales = json.load(f)
    return {m: {site: float(v) for site, v in d.items()} for m, d in scales.items()}


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
    format or a reference Keras ``.h5``, imported strictly unless
    ``h5_strict=False`` (:func:`train.checkpoint.import_h5_weights`; the
    report is printed).  Members without weights get Keras-initialised ones
    from ``torch.Generator().manual_seed(seed + i)``, which is also the
    starting point of an ``.h5`` import.

    ``fused=True`` runs the members over shared tiles in one dispatch per
    scene group; ``fused=False`` runs each member through its own
    :class:`~building_detection_tpu_torch.infer.engine.TiledPredictor`.

    ``mesh`` (a mesh of local devices, :func:`parallel.mesh.make_mesh`)
    shards the fused predictor's tile chunks over its data axis,
    ``batch_tiles`` per shard; the blocked path runs through the same
    dispatches, so tile-parallel too.  The mesh names the devices, so
    ``device`` stays ``None``.  Unlike the JAX package, which drops a mesh
    under ``fused=False``, ``Pipeline(fused=False, mesh=...)`` raises a
    ``ValueError``: the mesh needs ``fused=True``.  A mesh with a ``model``
    axis raises the fused predictor's ``ValueError``, before any weight
    loads.

    ``max_scene_tiles``: scenes whose tile grid exceeds it run through the
    blocked path (``infer/large_scene.py``), blocks of ``batch_tiles`` tiles,
    so the scene canvas on the device is O(block) and the masks are the
    whole-scene ones.  ``None`` turns blocking off.  Blocking needs the
    default ``fix_nonsquare_bug=True`` grid: a big scene in bug mode raises.

    ``int8_pointwise`` (``True`` or a minimum input-channel count) opts
    into int8 pointwise convs (``nn.layers.int8_pointwise_conv``): NOT
    mask-parity.  Static activation scales come from ``int8_scales``
    (:func:`load_int8_scales`) or, without them, from calibrating on the
    ``int8_calibration`` scenes here; with neither every site takes a
    dynamic per-call scale.  ``self.int8_scales`` keeps what was used, for
    :func:`save_int8_scales`.
    """

    def __init__(
        self,
        weights: Optional[Dict[str, str]] = None,
        cfg: Config = Config(),
        batch_tiles: int = DEFAULT_BATCH_TILES,
        compute_dtype: torch.dtype = torch.bfloat16,
        models: tuple = ENSEMBLE_ORDER,
        seed: int = 0,
        device=None,
        fused: bool = True,
        mesh=None,
        max_scene_tiles: Optional[int] = 1024,
        h5_strict: bool = True,
        int8_pointwise=False,
        int8_calibration: Optional[List[np.ndarray]] = None,
        int8_scales: Optional[Dict[str, Dict[str, float]]] = None,
    ):
        if mesh is not None and not fused:
            raise ValueError(
                "Pipeline(mesh=...) needs fused=True: the per-model engine takes no mesh here; run the fused "
                "Pipeline(mesh=...), or one member at a time through TiledPredictor(model, mesh=..., tp=...)"
            )
        check_data_only(mesh)
        home = predictor_devices(mesh, device)[0]  # every device checked before any weight loads
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
                model = init_model(name, torch.Generator().manual_seed(seed + i))
                params, state, report = import_h5_weights(path, *jax_variables(model), strict=h5_strict)
                print(f"[pipeline] {name}: {report.summary()}")
                members[name] = load_jax_variables(model, params, state)
            else:
                params, state, *_ = load_variables(path)
                members[name] = load_jax_variables(build_model(name), params, state)
        # each member module goes to exactly one predictor, which owns it
        int8 = {"int8_pointwise": int8_pointwise, "int8_scales": int8_scales}
        if fused:
            self.ensemble = FusedEnsemblePredictor(members, cfg.tiler, batch_tiles, compute_dtype, device, mesh=mesh,
                                                   **int8)
        else:
            self.ensemble = EnsemblePredictor(members, cfg.tiler, batch_tiles, compute_dtype, home, **int8)
        if int8_pointwise and int8_scales is None and int8_calibration:
            # calibrated where the members now live: on the home device, in compute_dtype
            int8_scales = calibrate_members_int8(
                members, int8_calibration, cfg, compute_dtype, int8_pointwise
            )
            self.ensemble.set_int8(int8_pointwise, int8_scales)
        self.int8_scales = int8_scales
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
