"""Res34-UNet: ResNet-34-style encoder, UNet decoder, SE attention.

The counterpart of ``building_detection_tpu/models/res34_unet.py``: a stem
of three conv64-BN-ReLU, strided 1x1 convs ``pool1..4`` between residual
stages [3, 4, 6, 3] at 64/128/256/512, the ``low_to_high`` cross-scale
aggregation twice, SE on all five levels, four ConvT decoder stages and a
3x3 conv64 -> 3x3 conv2 softmax head.  (B, H, W, 3) -> (B, H, W, 2) for H, W
divisible by 16.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from building_detection_tpu_torch.core.module import Namer
from building_detection_tpu_torch.nn import layers as L
from building_detection_tpu_torch.nn.attention import SEBlock

F_SIZE = 64


class _BNConv(nn.Module):
    FOLDS = (("conv", "bn"),)  # nn/fold.py: the conv's output feeds the BN alone

    def __init__(self, namer: Namer, in_ch: int, features: int, kernel: int, name: str):
        super().__init__()
        self.conv = L.Conv2d(namer, in_ch, features, kernel, kernel_init=L.he_normal, name=name)
        self.bn = L.BatchNorm(namer, features, name=f"{name}_BN")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return L.relu(self.bn(self.conv(x)))


class _ResBlock(nn.Module):
    def __init__(self, namer: Namer, ch: int, name: str):
        super().__init__()
        self.conv1 = _BNConv(namer, ch, ch, 3, f"{name}_1")
        self.conv2 = _BNConv(namer, ch, ch, 3, f"{name}_2")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return L.relu(x + self.conv2(self.conv1(x)))


class Encoder(nn.Module):
    """The reference's ResNet-34 encoder (22,910,272 trainable params)."""

    def __init__(self, namer: Namer):
        super().__init__()
        f = F_SIZE
        self.stem = nn.Sequential(
            _BNConv(namer, 3, f, 3, "conv1_1"),
            _BNConv(namer, f, f, 3, "conv1_2"),
            _BNConv(namer, f, f, 3, "conv1_3"),
        )
        self.stages = nn.ModuleList()
        in_ch = f
        for level, (ch, blocks) in enumerate(((f, 3), (f * 2, 4), (f * 4, 6), (f * 8, 3))):
            pool = L.Conv2d(namer, in_ch, ch, 1, strides=2, name=f"pool{level + 1}")
            res = [_ResBlock(namer, ch, f"conv{level + 2}_{i}") for i in range(blocks)]
            self.stages.append(nn.Sequential(pool, *res))
            in_ch = ch

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        outs = [L.stage(self, self.stem, x)]
        for stage in self.stages:
            outs.append(L.stage(self, stage, outs[-1]))
        return tuple(outs)


class _LowToHigh(nn.Module):
    """Inject maxpooled lower-level features upward."""

    def __init__(self, namer: Namer, low_ch: int, mid_ch: int, high_ch: int):
        super().__init__()
        self.high_ch = high_ch + mid_ch + low_ch
        self.mid_ch = mid_ch + low_ch
        self.high = L.Conv2d(namer, self.high_ch, self.high_ch, 1, activation="relu", kernel_init=L.he_normal)
        self.mid = L.Conv2d(namer, self.mid_ch, self.mid_ch, 1, activation="relu", kernel_init=L.he_normal)

    def forward(self, low, mid, high):
        low_x2 = L.max_pool(low)
        low_x4 = L.max_pool(low, pool_size=2, strides=4)
        high_out = self.high(torch.cat([high, L.max_pool(mid), low_x4], dim=-1))
        mid_out = self.mid(torch.cat([mid, low_x2], dim=-1))
        return mid_out, high_out


class _UpsampleFeature(nn.Module):
    """ConvT x2 + skip concat + 1x1 conv + residual block."""

    def __init__(self, namer: Namer, low_ch: int, high_ch: int, name: str):
        super().__init__()
        self.up = L.Conv2dTranspose(namer, high_ch, low_ch, 2, strides=2, activation="relu")
        self.conv = L.Conv2d(namer, 2 * low_ch, low_ch, 1, activation="relu", kernel_init=L.he_normal)
        self.res = _ResBlock(namer, low_ch, f"upsame_{name}")

    def forward(self, low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
        return self.res(self.conv(torch.cat([low, self.up(high)], dim=-1)))


class Res34UNet(nn.Module):
    def __init__(self):
        super().__init__()
        namer = Namer()
        f = F_SIZE
        self.encoder = Encoder(namer)
        self.l2h1 = _LowToHigh(namer, f, f, f * 2)
        self.l2h2 = _LowToHigh(namer, self.l2h1.mid_ch, self.l2h1.high_ch, f * 4)
        chans = (f, self.l2h1.mid_ch, self.l2h2.mid_ch, self.l2h2.high_ch, f * 8)
        self.se = nn.ModuleList(SEBlock(namer, ch) for ch in chans)
        self.ups = nn.ModuleList()
        high_ch = chans[4]
        for level in (3, 2, 1, 0):
            self.ups.append(_UpsampleFeature(namer, chans[level], high_ch, str(level + 1)))
            high_ch = chans[level]
        self.head1 = L.Conv2d(namer, f, 64, 3, activation="relu", kernel_init=L.he_normal)
        self.head2 = L.Conv2d(namer, 64, 2, 3, activation="softmax", kernel_init=L.he_normal)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the encoder stages and the decoder's upsampling steps are the JAX
        # model's remat stages; the cross-scale blocks, the SE gates and the
        # head run as segments of their own
        c1, c2, c3, c4, c5 = self.encoder(x)
        c2, c3 = L.stage(self, self.l2h1, c1, c2, c3)
        c3, c4 = L.stage(self, self.l2h2, c2, c3, c4)
        feats = [L.stage(self, se, c) for se, c in zip(self.se, (c1, c2, c3, c4, c5))]
        y = feats[4]
        for up, low in zip(self.ups, (feats[3], feats[2], feats[1], feats[0])):
            y = L.stage(self, up, low, y)
        return L.stage(self, lambda v: self.head2(self.head1(v)), y)
