"""The one traffic generator: aerial scenes and their building labels from a seed.

A traffic mix is a JSON file under ``benchmark/traffic/`` whose ``scene``
group sets what a scene looks like.  Every scene of a mix has the same size
and the same number of buildings, so every seed asks the program for the
same work; the seed moves only where the buildings stand and what the
ground looks like.

* Ground: a smooth colour field (random colours on a coarse grid, bilinearly
  upsampled), plus a mid-frequency texture and pixel noise.
* Buildings: ``buildings`` rotated rectangles a scene, half-sides drawn from
  ``half_side_px``, roofs of one random grey-brown colour each, with a darker
  rim ``rim_px`` wide.  The label is 255 inside a building and 0 elsewhere.

Scenes are made on the device in blocks of ``block`` scenes, from a
``torch.Generator`` on that device, so the same seed gives the same scenes on
the same kind of device.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed derived from ``seed`` and ``tags`` (any seed size)."""
    text = ":".join(str(t) for t in (seed, *tags)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def _block(p: Dict, n: int, size: int, g: torch.Generator, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n`` scenes of ``size``: (n, size, size, 3) uint8 and (n, size, size) uint8 {0, 255}."""
    grid = max(2, size // int(p["ground_cell_px"]))
    base = torch.rand((n, 3, grid, grid), generator=g, device=device) * float(p["ground_range"]) + float(p["ground_low"])
    img = F.interpolate(base, size=(size, size), mode="bilinear", align_corners=False)
    tex_grid = max(2, size // int(p["texture_cell_px"]))
    tex = torch.randn((n, 1, tex_grid, tex_grid), generator=g, device=device)
    img = img + float(p["texture_amp"]) * F.interpolate(tex, size=(size, size), mode="bilinear", align_corners=False)
    img = img.permute(0, 2, 3, 1)  # (n, size, size, 3)

    k = int(p["buildings"])
    lo, hi = p["half_side_px"]
    centre = torch.rand((n, k, 2), generator=g, device=device) * size
    half = torch.rand((n, k, 2), generator=g, device=device) * (hi - lo) + lo
    angle = torch.rand((n, k), generator=g, device=device) * math.pi
    roof = torch.rand((n, k, 1), generator=g, device=device) * float(p["roof_range"]) + float(p["roof_low"])
    tint = torch.rand((n, k, 3), generator=g, device=device) * float(p["roof_tint"])
    rim = float(p["rim_px"])

    coords = torch.arange(size, device=device, dtype=torch.float32) + 0.5
    ys, xs = coords[:, None], coords[None, :]
    label = torch.zeros((n, size, size), dtype=torch.bool, device=device)
    for b in range(k):
        cy, cx = centre[:, b, 0, None, None], centre[:, b, 1, None, None]
        cos, sin = torch.cos(angle[:, b])[:, None, None], torch.sin(angle[:, b])[:, None, None]
        u = (xs - cx) * cos + (ys - cy) * sin
        v = (ys - cy) * cos - (xs - cx) * sin
        hu, hv = half[:, b, 0, None, None], half[:, b, 1, None, None]
        inside = (u.abs() < hu) & (v.abs() < hv)
        core = (u.abs() < hu - rim) & (v.abs() < hv - rim)
        colour = roof[:, b][:, None, None, :] + tint[:, b][:, None, None, :]
        img = torch.where(inside[..., None], colour * 0.6, img)
        img = torch.where(core[..., None], colour, img)
        label |= inside
    img = img + float(p["noise_amp"]) * torch.randn(img.shape, generator=g, device=device)
    img = img.clamp(0.0, 255.0).round().to(torch.uint8)
    return img, label.to(torch.uint8) * 255


def scenes(p: Dict, seed: int, count: int, size: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``count`` scenes of ``size`` x ``size`` drawn from ``seed`` with the
    mix's ``scene`` parameters ``p``: ``(images, labels)`` on ``device``,
    (count, size, size, 3) uint8 and (count, size, size) uint8 in {0, 255}."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "scenes", size))
    images = torch.empty((count, size, size, 3), dtype=torch.uint8, device=device)
    labels = torch.empty((count, size, size), dtype=torch.uint8, device=device)
    block = int(p.get("block", 64))
    for start in range(0, count, block):
        n = min(block, count - start)
        images[start : start + n], labels[start : start + n] = _block(p, n, size, g, device)
    return images, labels
