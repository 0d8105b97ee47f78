"""Attention blocks shared by the model zoo, NHWC in and out.

The counterparts of ``building_detection_tpu/nn/attention.py``.  Each block
builds its layers in the order the JAX function calls them, so the Keras
auto-names agree.
"""
from __future__ import annotations

import torch
from torch import nn

from building_detection_tpu_torch.core.module import Namer
from building_detection_tpu_torch.nn import layers as L


class SEBlock(nn.Module):
    """Squeeze-excite: GAP -> Dense(C/2) -> BN -> ReLU -> Dense(C) -> BN ->
    sigmoid -> scale."""

    def __init__(self, namer: Namer, ch: int):
        super().__init__()
        self.dense1 = L.Dense(namer, ch, ch // 2)
        self.bn1 = L.BatchNorm(namer, ch // 2)
        self.dense2 = L.Dense(namer, ch // 2, ch)
        self.bn2 = L.BatchNorm(namer, ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = L.relu(self.bn1(self.dense1(L.global_avg_pool(x))))
        f = L.sigmoid(self.bn2(self.dense2(f)))
        return x * f[:, None, None, :]


class SSEBlock(nn.Module):
    """Spatial squeeze-excite: 1x1 conv -> sigmoid gate."""

    def __init__(self, namer: Namer, ch: int):
        super().__init__()
        self.conv = L.Conv2d(namer, ch, 1, 1, activation="sigmoid")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x) * x


class CSEBlock(nn.Module):
    """Channel squeeze-excite: GAP -> 1x1 conv C/16 -> 1x1 conv C ->
    sigmoid (the reference hard-codes ``// 16``)."""

    def __init__(self, namer: Namer, ch: int):
        super().__init__()
        self.conv1 = L.Conv2d(namer, ch, ch // 16, 1)
        self.conv2 = L.Conv2d(namer, ch // 16, ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.conv2(self.conv1(L.global_avg_pool(x, keepdims=True)))
        return L.sigmoid(g) * x


class SCSEBlock(nn.Module):
    def __init__(self, namer: Namer, ch: int):
        super().__init__()
        self.sse = SSEBlock(namer, ch)
        self.cse = CSEBlock(namer, ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.sse(x) + self.cse(x)


class BAMChannelGate(nn.Module):
    """GAP -> Dense(C/16) -> BN -> ReLU -> Dense(C/16) -> BN -> ReLU ->
    Dense(C), no activation: (B, C)."""

    def __init__(self, namer: Namer, ch: int, rate: int = 16):
        super().__init__()
        self.dense1 = L.Dense(namer, ch, ch // rate)
        self.bn1 = L.BatchNorm(namer, ch // rate)
        self.dense2 = L.Dense(namer, ch // rate, ch // rate)
        self.bn2 = L.BatchNorm(namer, ch // rate)
        self.dense3 = L.Dense(namer, ch // rate, ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = L.relu(self.bn1(self.dense1(L.global_avg_pool(x))))
        f = L.relu(self.bn2(self.dense2(f)))
        return self.dense3(f)


class BAMSpatialGate(nn.Module):
    """1x1 C/16 -> two 3x3 dilated (d=4) -> 1x1 to one channel: (B,H,W,1)."""

    FOLDS = (("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3"))  # nn/fold.py

    def __init__(self, namer: Namer, ch: int, rate: int = 16, d: int = 4):
        super().__init__()
        mid = ch // rate
        self.conv1 = L.Conv2d(namer, ch, mid, 1)
        self.bn1 = L.BatchNorm(namer, mid)
        self.conv2 = L.Conv2d(namer, mid, mid, 3, dilation=d)
        self.bn2 = L.BatchNorm(namer, mid)
        self.conv3 = L.Conv2d(namer, mid, mid, 3, dilation=d)
        self.bn3 = L.BatchNorm(namer, mid)
        self.conv4 = L.Conv2d(namer, mid, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = L.relu(self.bn1(self.conv1(x)))
        f = L.relu(self.bn2(self.conv2(f)))
        f = L.relu(self.bn3(self.conv3(f)))
        return self.conv4(f)


class BAMAttention(nn.Module):
    """Bottleneck Attention Module: ``x * sigmoid(c + s) + x``."""

    def __init__(self, namer: Namer, ch: int):
        super().__init__()
        self.channel = BAMChannelGate(namer, ch)
        self.spatial = BAMSpatialGate(namer, ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.channel(x)[:, None, None, :]
        gate = L.sigmoid(c + self.spatial(x))
        return x * gate + x


class _ConvBNReLU(nn.Module):
    FOLDS = (("conv", "bn"),)  # nn/fold.py: the conv's output feeds the BN alone

    def __init__(self, namer: Namer, in_ch: int, features: int, kernel: int, dilation: int = 1):
        super().__init__()
        self.conv = L.Conv2d(namer, in_ch, features, kernel, dilation=dilation)
        self.bn = L.BatchNorm(namer, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return L.relu(self.bn(self.conv(x)))


class SKNetBlock(nn.Module):
    """Selective-kernel block over five branches (d=1, 6, 12, 18 and GAP):
    the five heads are softmaxed across a branch axis."""

    def __init__(self, namer: Namer, in_ch: int, reduce: int = 16):
        super().__init__()
        ch = 256
        self.stem = _ConvBNReLU(namer, in_ch, ch, 3)
        self.branches = nn.ModuleList(
            _ConvBNReLU(namer, ch, ch, 1 if d == 1 else 3, dilation=d) for d in (1, 6, 12, 18)
        )
        self.gap = _ConvBNReLU(namer, ch, ch, 1)
        self.squeeze = _ConvBNReLU(namer, ch, ch // reduce, 1)
        self.heads = nn.ModuleList(L.Conv2d(namer, ch // reduce, ch, 1) for _ in range(5))
        self.bn = L.BatchNorm(namer, ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.stem(x)
        d1, d6, d12, d18 = (b(conv) for b in self.branches)
        gap = self.gap(L.global_avg_pool(conv, keepdims=True)).expand_as(conv)
        total = d1 + d6 + d12 + d18 + gap
        z = self.squeeze(L.global_avg_pool(total, keepdims=True))
        logits = torch.stack([h(z) for h in self.heads], dim=1)  # (B,5,1,1,C)
        weights = torch.softmax(logits, dim=1)
        branches = torch.stack([d1, d6, d12, d18, gap], dim=1)  # (B,5,H,W,C)
        fused = torch.sum(branches * weights, dim=1)
        return L.relu(self.bn(fused))
