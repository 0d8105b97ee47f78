"""Sliding-window tiler: geometry on the host, normalize/gather/scatter on tensors.

The counterpart of ``building_detection_tpu/ops/tiling.py``.  The geometry
reproduces the reference's padding math ``new = ceil((dim-152)/360)*360 +
152``, at least 512, including the no-tile case for dims <= overlap, and its
mis-tiling of non-square scenes under ``fix_nonsquare_bug=False``.  The
gather and the OR-scatter are tensor ops on whatever device the canvas lives.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from building_detection_tpu_torch.core.config import TilerConfig


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Static tiling geometry for one scene shape."""

    height: int
    width: int
    canvas_h: int
    canvas_w: int
    origins: Tuple[Tuple[int, int], ...]  # (row, col) of each tile

    @property
    def num_tiles(self) -> int:
        return len(self.origins)


def _axis_tiles(dim: int, cfg: TilerConfig) -> Tuple[int, int]:
    """(padded size, number of tiles) along one axis."""
    n = max(math.ceil((dim - cfg.overlap) / cfg.stride), 0)
    new = n * cfg.stride + cfg.overlap
    return max(new, cfg.tile), n


def plan_tiles(height: int, width: int, cfg: TilerConfig = TilerConfig()) -> TilePlan:
    canvas_h, n_h = _axis_tiles(height, cfg)
    canvas_w, n_w = _axis_tiles(width, cfg)
    if not cfg.fix_nonsquare_bug:
        # The reference's inner loop runs over the height-derived count: wide
        # scenes are under-tiled, and on tall scenes the column origins
        # overrun the canvas and the reference itself crashes.
        n_w = n_h
        if n_w and (n_w - 1) * cfg.stride + cfg.tile > canvas_w:
            raise ValueError(
                f"fix_nonsquare_bug=False on a tall scene ({height}x{width}): "
                "the reference's inner loop (predict.py:106) overruns the "
                "canvas width, feeding the model truncated tiles — the "
                "reference itself crashes here (decoder shape mismatch). "
                "Use fix_nonsquare_bug=True for correct non-square tiling."
            )
    origins = tuple(
        (i * cfg.stride, j * cfg.stride) for i in range(n_h) for j in range(n_w)
    )
    return TilePlan(height, width, canvas_h, canvas_w, origins)


def bucket_plan(plan: TilePlan, cfg: TilerConfig = TilerConfig()) -> TilePlan:
    """Round the canvas up to a power-of-two tile grid per axis and pad the
    origins by repeating the last real one (OR is idempotent), so the
    cropped mask is the unbucketed one."""
    if plan.num_tiles == 0:
        return plan

    def bucket_axis(size: int) -> Tuple[int, int]:
        n = max(-(-(size - cfg.overlap) // cfg.stride), 1)
        nb = 1
        while nb < n:
            nb *= 2
        return nb * cfg.stride + cfg.overlap, nb

    canvas_h, n_hb = bucket_axis(plan.canvas_h)
    canvas_w, n_wb = bucket_axis(plan.canvas_w)
    origins = plan.origins + (plan.origins[-1],) * (n_hb * n_wb - plan.num_tiles)
    return TilePlan(plan.height, plan.width, canvas_h, canvas_w, origins)


def normalize(img: torch.Tensor, cfg: TilerConfig = TilerConfig(), dtype=torch.float32) -> torch.Tensor:
    """uint8 RGB -> float in [-1, 1], equal to the reference's
    ``f32(f64(v) / 127.5 - 1)`` on all 256 values.

    ``x / 127.5 - 1`` in f32 is 1 ulp off for half the uint8 range, and on
    CUDA torch turns a division by a scalar into a multiplication by its
    reciprocal, which is off too.  ``v - 127.5`` is exact for every uint8,
    and one Newton correction on the product with the f32 reciprocal rounds
    like the true quotient (the JAX package's form).  The constants are
    Python scalars, so no host-to-device copy (and no stream sync) happens.
    """
    if img.dtype.is_floating_point:
        return img.to(dtype) / cfg.normalize_div - 1.0
    d = float(np.float32(cfg.normalize_div))
    r = float(np.float32(1.0) / np.float32(d))
    num = img.to(torch.float32) - d
    q0 = num * r
    return (q0 + (num - q0 * d) * r).to(dtype)


def origins_array(plan: TilePlan) -> np.ndarray:
    if plan.num_tiles == 0:
        return np.zeros((0, 2), np.int32)
    return np.array(plan.origins, np.int32)


def extract_tiles(canvas: torch.Tensor, origins: torch.Tensor, tile: int) -> torch.Tensor:
    """Gather ``(T, tile, tile, C)`` windows from an ``(H, W, C)`` canvas
    (``origins``: ``(T, 2)`` rows and columns, on the canvas' device)."""
    ar = torch.arange(tile, device=canvas.device)
    rows = (origins[:, 0, None] + ar)[:, :, None]
    cols = (origins[:, 1, None] + ar)[:, None, :]
    return canvas[rows, cols]


def scatter_or(masks: torch.Tensor, origins, canvas_hw: Tuple[int, int]) -> torch.Tensor:
    """OR (max) each ``(T, tile, tile)`` binary mask back onto an ``(H, W)``
    canvas: the reference's ``+=`` then ``>= 1``, without overflow."""
    tile = masks.shape[1]
    canvas = torch.zeros(canvas_hw, dtype=masks.dtype, device=masks.device)
    for m, (r, c) in zip(masks, np.asarray(origins).tolist()):
        view = canvas[r : r + tile, c : c + tile]
        torch.maximum(view, m, out=view)
    return canvas
