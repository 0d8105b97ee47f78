"""The reference's sliding-window prediction, per member, in plain float32.

After the reference repository's ``predict.py:90-116``: a scene is scaled to
``v / 127.5 - 1`` (in float64, then float32), padded with 0.0 to
``ceil((dim - overlap) / stride) * stride + overlap`` (at least one tile),
cut into ``tile`` x ``tile`` windows every ``stride`` pixels, and a pixel of
a member's mask is set where any window over it puts class 1 first.

:func:`margins` returns, instead of the bits, each pixel's margin: the
largest ``logit_1 - logit_0`` over the windows that cover it.  The mask is
``margin > 0``; the margin says how far a pixel is from flipping.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch
from torch import nn


def axis(dim: int, tile: int, stride: int) -> Tuple[int, int]:
    """(padded size, windows) along one axis."""
    overlap = tile - stride
    n = max(math.ceil((dim - overlap) / stride), 0)
    return max(n * stride + overlap, tile), n


def origins(h: int, w: int, tile: int, stride: int) -> List[Tuple[int, int]]:
    (_, nh), (_, nw) = axis(h, tile, stride), axis(w, tile, stride)
    return [(i * stride, j * stride) for i in range(nh) for j in range(nw)]


def num_tiles(h: int, w: int, tile: int, stride: int) -> int:
    return len(origins(h, w, tile, stride))


def normalize(u8: torch.Tensor) -> torch.Tensor:
    return (u8.double() / 127.5 - 1.0).float()


@torch.no_grad()
def margins(model: nn.Module, scene: torch.Tensor, tile: int, stride: int, batch: int) -> torch.Tensor:
    """(H, W) float32 margins of ``model`` (returning logits) over one
    (H, W, 3) uint8 ``scene``, on the scene's device."""
    h, w = scene.shape[:2]
    (ch, _), (cw, _) = axis(h, tile, stride), axis(w, tile, stride)
    canvas = torch.zeros((ch, cw, 3), dtype=torch.float32, device=scene.device)
    canvas[:h, :w] = normalize(scene)
    out = torch.full((ch, cw), float("-inf"), dtype=torch.float32, device=scene.device)
    where = origins(h, w, tile, stride)
    for start in range(0, len(where), batch):
        part = where[start : start + batch]
        tiles = torch.stack([canvas[r : r + tile, c : c + tile] for r, c in part])
        z = model(tiles)
        d = z[..., 1] - z[..., 0]
        for (r, c), m in zip(part, d):
            view = out[r : r + tile, c : c + tile]
            torch.maximum(view, m, out=view)
    return out[:h, :w]
