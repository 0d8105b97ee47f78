"""Blocked prediction: scenes larger than device memory, bit for bit.

The counterpart of ``building_detection_tpu/infer/large_scene.py``, host
code over the port's ``ops/tiling.py``.  The engine and the fused predictor
keep the whole normalized scene canvas on the device, O(scene) memory; the
reference keeps its canvas in host RAM and runs one tile at a time
(`predict.py:98-116`).  This module holds device memory to O(block)
without changing one output bit, on two facts:

* **The tile grid is block-decomposable.**  Origins sit at multiples of
  ``stride`` and a tile spans ``tile <= stride + overlap`` pixels, so a
  block covering ``k`` consecutive origin rows spans ``k*stride + overlap``
  canvas rows, and ``plan_tiles`` of that slice reproduces the global
  origins shifted by the block offset (the padding rule ``new =
  ceil((dim-overlap)/stride)*stride + overlap``, `predict.py:98-102`,
  telescopes across the cut).  :func:`plan_blocks` asserts it per block.
* **The canvas combine is an OR.**  Every output pixel is the OR of the
  tile masks covering it (`predict.py:113-114`).  Blocks partition the tile
  set, so OR-ing block masks into the scene mask reproduces the whole-scene
  result exactly.

At most ``max_in_flight`` blocks are dispatched and not yet fetched at any
time: each holds its pinned upload, its device canvas and its output
buffer, so that bound is what keeps device memory O(block).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np

from building_detection_tpu_torch.core.config import TilerConfig
from building_detection_tpu_torch.ops import tiling as T


@dataclasses.dataclass(frozen=True)
class Block:
    """One rectangular chunk of the scene's tile grid."""

    r0: int      # image/canvas row offset of the block slice
    c0: int      # image/canvas col offset
    rows: int    # real image rows in the slice (pad is re-derived locally)
    cols: int    # real image cols


def plan_blocks(
    height: int,
    width: int,
    cfg: TilerConfig = TilerConfig(),
    max_block_tiles: int = 128,
) -> Optional[List[Block]]:
    """Partition the scene's tile grid into blocks of <= ``max_block_tiles``.

    Returns ``None`` when blocking is unnecessary (the whole scene fits the
    budget, or it is degenerate).  Blocks are near-square in tile units, so
    block canvases stay small in both dimensions.
    """
    if not cfg.fix_nonsquare_bug:
        # the faithful-bug grid couples the width tile count to the HEIGHT
        # (`predict.py:106`); a block's local plan would re-derive it from the
        # block's height and diverge
        raise ValueError("blocked prediction requires fix_nonsquare_bug=True")
    if cfg.tile > cfg.stride + cfg.overlap:
        # tiles would read past the local canvas
        raise ValueError("blocked prediction requires tile <= stride + overlap")
    _, n_h = T._axis_tiles(height, cfg)
    _, n_w = T._axis_tiles(width, cfg)
    if n_h * n_w <= max_block_tiles or n_h == 0 or n_w == 0:
        return None
    k = max(int(math.isqrt(max_block_tiles)), 1)
    k_w = min(n_w, k)
    k_h = min(n_h, max(max_block_tiles // k_w, 1))
    blocks: List[Block] = []
    for i0 in range(0, n_h, k_h):
        i1 = min(i0 + k_h, n_h) - 1
        r0 = i0 * cfg.stride
        rows = min(i1 * cfg.stride + cfg.tile, height) - r0
        for j0 in range(0, n_w, k_w):
            j1 = min(j0 + k_w, n_w) - 1
            c0 = j0 * cfg.stride
            cols = min(j1 * cfg.stride + cfg.tile, width) - c0
            # the local plan must reproduce the global grid restricted to
            # this block (the decomposition this module rests on)
            _, bn_h = T._axis_tiles(rows, cfg)
            _, bn_w = T._axis_tiles(cols, cfg)
            assert bn_h == i1 - i0 + 1 and bn_w == j1 - j0 + 1, (
                "tile grid not block-decomposable",
                (rows, cols, bn_h, bn_w, i0, i1, j0, j1),
            )
            blocks.append(Block(r0, c0, rows, cols))
    return blocks


def _view(image_rgb: np.ndarray, b: Block) -> np.ndarray:
    return np.ascontiguousarray(image_rgb[b.r0 : b.r0 + b.rows, b.c0 : b.c0 + b.cols])


def _or_into(out: np.ndarray, b: Block, mask: np.ndarray) -> None:
    region = out[b.r0 : b.r0 + b.rows, b.c0 : b.c0 + b.cols]
    np.maximum(region, mask, out=region)


def predict_mask_blocked(
    predictor,
    image_rgb: np.ndarray,
    max_block_tiles: int = 128,
    max_in_flight: int = 8,
) -> np.ndarray:
    """One model's blocked prediction through a ``TiledPredictor``: at most
    ``max_in_flight`` blocks dispatched at once, later blocks' uploads
    overlapping earlier blocks' compute; fetched and OR-stitched in
    dispatch order."""
    h, w = image_rgb.shape[:2]
    blocks = plan_blocks(h, w, predictor.cfg, max_block_tiles)
    if blocks is None:
        return predictor.predict_mask(image_rgb)
    out = np.zeros((h, w), np.uint8)
    pending: List[tuple] = []
    for b in blocks:
        pending.append((b, predictor.dispatch(_view(image_rgb, b))))
        if len(pending) >= max(int(max_in_flight), 1):
            done, handle = pending.pop(0)
            _or_into(out, done, predictor.fetch(handle))
    for done, handle in pending:
        _or_into(out, done, predictor.fetch(handle))
    return out


def predict_masks_blocked(
    ensemble,
    image_rgb: np.ndarray,
    max_block_tiles: int = 128,
    max_in_flight: int = 8,
) -> Dict[str, np.ndarray]:
    """Ensemble blocked prediction: per-model full-scene {0, 255} masks.

    Over a ``FusedEnsemblePredictor`` the blocks stream through its
    pipelined ``predict_masks_iter`` (same-shape interior blocks group into
    full dispatches, at most ``max_in_flight`` groups in flight); over an
    ``EnsemblePredictor`` they run one at a time.  Falls back to
    ``predict_masks`` when the scene fits the budget.
    """
    h, w = image_rgb.shape[:2]
    blocks = plan_blocks(h, w, ensemble.cfg, max_block_tiles)
    if blocks is None:
        return ensemble.predict_masks(image_rgb)
    views = [_view(image_rgb, b) for b in blocks]
    out = {name: np.zeros((h, w), np.uint8) for name in ensemble.names}
    if hasattr(ensemble, "predict_masks_iter"):
        it = ensemble.predict_masks_iter(views, max_in_flight=max_in_flight)
    else:
        it = ((i, ensemble.predict_masks(v)) for i, v in enumerate(views))
    for idx, masks in it:
        for name, m in masks.items():
            _or_into(out[name], blocks[idx], m)
    return out
