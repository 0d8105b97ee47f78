"""On-device training augmentation: ``augment_batch`` of the JAX package, split in two.

The counterpart of ``building_detection_tpu/data/augment.py::augment_batch``
(the reference's ``Data_Enhance`` menu, applied in place per sample):

* p=0.8 flip up-down, p=0.8 flip left-right;
* p=0.8 scale by 0.6-2.0x about the centre as one bilinear resample of the
  source grid, gray-128 padding where the source runs out, the label
  re-binarised at 125;
* p=0.3 channel swap (RGB <-> BGR).

:func:`apply_augment` does the work from explicit per-sample decisions;
:func:`draw_decisions` draws them from a CPU ``torch.Generator`` seeded from
``(augment_seed, step)``, so a step's batch is the same on every device and
on the staged and per-step paths.  torch cannot reproduce JAX's threefry
bits, so the tests hand both packages the same decisions.
``DatasetBuilder`` (the offline builder) is not ported.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from building_detection_tpu_torch.core.config import AugmentConfig


class Decisions(NamedTuple):
    """Per-sample choices, each ``(N,)``: booleans and f32 ``scales``."""

    do_ud: torch.Tensor
    do_lr: torch.Tensor
    do_sc: torch.Tensor
    scales: torch.Tensor
    do_col: torch.Tensor


def draw_decisions(n: int, augment_seed: int, step: int, cfg: AugmentConfig = AugmentConfig()) -> Decisions:
    """The decisions of global step ``step``, on the CPU."""
    seed = int(np.random.SeedSequence([augment_seed, step]).generate_state(1, np.uint64)[0])
    gen = torch.Generator().manual_seed(seed)
    u = torch.rand((5, n), generator=gen)
    lo, hi = cfg.scale_range
    return Decisions(
        do_ud=u[0] < cfg.p_flip_ud,
        do_lr=u[1] < cfg.p_flip_lr,
        do_sc=u[2] < cfg.p_scale,
        scales=lo + u[3] * (hi - lo),
        do_col=u[4] < cfg.p_color,
    )


def _scale(images: torch.Tensor, labels: torch.Tensor, scales: torch.Tensor, cfg: AugmentConfig):
    """Every sample scaled by its own factor about the centre: one bilinear
    resample of the source grid, rounded; gray ``pad_value`` (image) and 0
    (label) outside the source; the label re-binarised at
    ``label_threshold``.  The f32 arithmetic is the JAX version's, in its
    order, so the bytes agree."""
    n, h, w = labels.shape
    dev = images.device
    s = scales.to(device=dev, dtype=torch.float32)[:, None]
    yy = (torch.arange(h, device=dev, dtype=torch.float32) - (h - 1) / 2.0) / s + (h - 1) / 2.0
    xx = (torch.arange(w, device=dev, dtype=torch.float32) - (w - 1) / 2.0) / s + (w - 1) / 2.0
    y0, x0 = torch.floor(yy), torch.floor(xx)
    fy, fx = yy - y0, xx - x0
    y0c, y1c = y0.long().clamp(0, h - 1), (y0.long() + 1).clamp(0, h - 1)
    x0c, x1c = x0.long().clamp(0, w - 1), (x0.long() + 1).clamp(0, w - 1)
    b = torch.arange(n, device=dev)[:, None, None]

    def bilinear(src: torch.Tensor) -> torch.Tensor:
        f = src.float()
        a, bb = f[b, y0c[:, :, None], x0c[:, None, :]], f[b, y0c[:, :, None], x1c[:, None, :]]
        c, d = f[b, y1c[:, :, None], x0c[:, None, :]], f[b, y1c[:, :, None], x1c[:, None, :]]
        extra = (None,) * (src.dim() - 3)
        wy = fy[(slice(None), slice(None), None) + extra]
        wx = fx[(slice(None), None, slice(None)) + extra]
        top = a * (1 - wx) + bb * wx
        bot = c * (1 - wx) + d * wx
        return torch.round(top * (1 - wy) + bot * wy)

    inside = (
        ((yy >= 0) & (yy <= h - 1))[:, :, None] & ((xx >= 0) & (xx <= w - 1))[:, None, :]
    )
    out_img = torch.where(inside[..., None], bilinear(images).to(torch.uint8), cfg.pad_value)
    out_lab = torch.where(inside, bilinear(labels).to(torch.uint8), 0)
    out_lab = torch.where(out_lab > cfg.label_threshold, 255, 0).to(torch.uint8)
    return out_img.to(torch.uint8), out_lab


def apply_augment(
    images: torch.Tensor,
    labels: torch.Tensor,
    decisions: Decisions,
    cfg: AugmentConfig = AugmentConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(N,H,W,3)`` u8, ``(N,H,W)`` u8 -> augmented, same shapes, on the
    inputs' device: flips, then the scale, then the channel swap."""
    dev = images.device
    ud, lr, sc, col = (t.to(dev) for t in (decisions.do_ud, decisions.do_lr, decisions.do_sc, decisions.do_col))
    images = torch.where(ud[:, None, None, None], images.flip(1), images)
    labels = torch.where(ud[:, None, None], labels.flip(1), labels)
    images = torch.where(lr[:, None, None, None], images.flip(2), images)
    labels = torch.where(lr[:, None, None], labels.flip(2), labels)
    s_img, s_lab = _scale(images, labels, decisions.scales, cfg)
    images = torch.where(sc[:, None, None, None], s_img, images)
    labels = torch.where(sc[:, None, None], s_lab, labels)
    images = torch.where(col[:, None, None, None], images.flip(3), images)
    return images, labels


def augment_batch(
    images: torch.Tensor,
    labels: torch.Tensor,
    augment_seed: int,
    step: int,
    cfg: AugmentConfig = AugmentConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The batch of global step ``step`` under ``augment_seed``."""
    return apply_augment(images, labels, draw_decisions(images.shape[0], augment_seed, step, cfg), cfg)
