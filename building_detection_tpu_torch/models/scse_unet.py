"""SCSE-UNet: UNet with an scSE block after every decoder stage.

The counterpart of ``building_detection_tpu/models/scse_unet.py``: encoder
64->128->256->512->1024 (double 3x3 conv + maxpool, no BN), Conv2DTranspose
decoder, 1x1 softmax head.  (B, H, W, 3) -> (B, H, W, 2) for H, W divisible
by 16.
"""
from __future__ import annotations

import torch
from torch import nn

from building_detection_tpu_torch.core.module import Namer
from building_detection_tpu_torch.nn import layers as L
from building_detection_tpu_torch.nn.attention import SCSEBlock


class _DoubleConv(nn.Sequential):
    def __init__(self, namer: Namer, in_ch: int, ch: int):
        super().__init__(
            L.Conv2d(namer, in_ch, ch, 3, activation="relu"),
            L.Conv2d(namer, ch, ch, 3, activation="relu"),
        )


class _UpStage(nn.Module):
    def __init__(self, namer: Namer, in_ch: int, skip_ch: int, ch: int):
        super().__init__()
        self.up = L.Conv2dTranspose(namer, in_ch, ch, 3, strides=2, activation="relu")
        self.conv = _DoubleConv(namer, ch + skip_ch, ch)
        self.scse = SCSEBlock(namer, ch)

    def forward(self, y: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        y = torch.cat([self.up(y), skip], dim=-1)
        return self.scse(self.conv(y))


class SCSEUNet(nn.Module):
    def __init__(self, num_classes: int = 2):
        super().__init__()
        namer = Namer()
        widths = (64, 128, 256, 512, 1024)
        self.down = nn.ModuleList()
        in_ch = 3
        for ch in widths:
            self.down.append(_DoubleConv(namer, in_ch, ch))
            in_ch = ch
        self.up = nn.ModuleList()
        for ch in reversed(widths[:-1]):
            self.up.append(_UpStage(namer, in_ch, ch, ch))
            in_ch = ch
        self.head = L.Conv2d(namer, in_ch, num_classes, 1, activation="softmax")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # every encoder and decoder stage is a remat stage of the JAX model
        skips = [L.stage(self, self.down[0], x)]
        for stage in self.down[1:]:
            skips.append(L.stage(self, lambda v, s=stage: s(L.max_pool(v)), skips[-1]))
        y = skips.pop()
        for stage in self.up:
            y = L.stage(self, stage, y, skips.pop())
        return self.head(y)
