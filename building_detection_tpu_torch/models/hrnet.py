"""HRNet: parallel resolutions with cross-resolution fusion.

The counterpart of ``building_detection_tpu/models/hrnet.py``: stem conv64
s2 -> layer1 (bottleneck + 3 identity blocks at 256 channels) -> three
transitions spawning branches at 32/64/128/256 channels and strides
2/4/8/16 -> four basic blocks per branch -> fuse blocks -> x2 upsample ->
conv64 -> 1x1 softmax.  (B, H, W, 3) -> (B, H, W, 2) for H, W divisible by 16.
"""
from __future__ import annotations

from typing import List

import torch
from torch import nn

from building_detection_tpu_torch.core.module import Namer
from building_detection_tpu_torch.nn import layers as L


class _CBR(nn.Module):
    FOLDS = (("conv", "bn"),)  # nn/fold.py: the conv's output feeds the BN alone

    def __init__(self, namer: Namer, in_ch: int, filters: int, kernel: int = 3, strides: int = 1, activate: bool = True):
        super().__init__()
        self.conv = L.Conv2d(namer, in_ch, filters, kernel, strides=strides)
        self.bn = L.BatchNorm(namer, filters)
        self.activate = activate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return L.relu(x) if self.activate else x


class _Bottleneck(nn.Module):
    """``_conv_block`` (with a projection shortcut) or ``_identity_block``."""

    def __init__(self, namer: Namer, in_ch: int, filters: int, project: bool):
        super().__init__()
        self.body = nn.Sequential(
            _CBR(namer, in_ch, filters // 4, 1),
            _CBR(namer, filters // 4, filters // 4, 3),
            _CBR(namer, filters // 4, filters, 1, activate=False),
        )
        self.short = _CBR(namer, in_ch, filters, 1, activate=False) if project else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.body(x)
        return L.relu(y + (self.short(x) if self.short is not None else x))


class _BasicBlock(nn.Module):
    def __init__(self, namer: Namer, filters: int):
        super().__init__()
        self.conv1 = _CBR(namer, filters, filters, 3)
        self.conv2 = _CBR(namer, filters, filters, 3, activate=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return L.relu(self.conv2(self.conv1(x)) + x)


def _branch(namer: Namer, channels: int) -> nn.Sequential:
    return nn.Sequential(*(_BasicBlock(namer, channels) for _ in range(4)))


class _Fuse1(nn.Module):
    """Two-branch fusion."""

    def __init__(self, namer: Namer):
        super().__init__()
        self.up = _CBR(namer, 64, 32, 1, activate=False)
        self.down = _CBR(namer, 32, 64, 3, strides=2, activate=False)

    def forward(self, x: List[torch.Tensor]) -> List[torch.Tensor]:
        x0 = x[0] + L.upsample2d(self.up(x[1]), 2)
        x1 = self.down(x[0]) + x[1]
        return [x0, x1]


class _Fuse2(nn.Module):
    """Three-branch fusion."""

    def __init__(self, namer: Namer):
        super().__init__()
        self.c12 = _CBR(namer, 64, 32, 1, activate=False)
        self.c13 = _CBR(namer, 128, 32, 1, activate=False)
        self.c21 = _CBR(namer, 32, 64, 3, 2, activate=False)
        self.c23 = _CBR(namer, 128, 64, 1, activate=False)
        self.c31a = _CBR(namer, 32, 32, 3, 2)
        self.c31b = _CBR(namer, 32, 128, 3, 2, activate=False)
        self.c32 = _CBR(namer, 64, 128, 3, 2, activate=False)

    def forward(self, x: List[torch.Tensor]) -> List[torch.Tensor]:
        x12 = L.upsample2d(self.c12(x[1]), 2)
        x13 = L.upsample2d(self.c13(x[2]), 4)
        x0 = x[0] + x12 + x13
        x21 = self.c21(x[0])
        x23 = L.upsample2d(self.c23(x[2]), 2)
        x1 = x21 + x[1] + x23
        x31 = self.c31b(self.c31a(x[0]))
        x32 = self.c32(x[1])
        x2 = x31 + x32 + x[2]
        return [x0, x1, x2]


class _Fuse3(nn.Module):
    """Final concat fusion to the highest resolution."""

    def __init__(self, namer: Namer):
        super().__init__()
        self.ups = nn.ModuleList(_CBR(namer, ch, 32, 1, activate=False) for ch in (64, 128, 256))

    def forward(self, x: List[torch.Tensor]) -> torch.Tensor:
        outs = [x[0]] + [L.upsample2d(up(v), 2 ** (i + 1)) for i, (up, v) in enumerate(zip(self.ups, x[1:]))]
        return torch.cat(outs, dim=-1)


class HRNet(nn.Module):
    def __init__(self, num_classes: int = 2):
        super().__init__()
        n = Namer()
        self.stem = _CBR(n, 3, 64, strides=2)
        self.layer1 = nn.Sequential(
            _Bottleneck(n, 64, 256, project=True),
            *(_Bottleneck(n, 256, 256, project=False) for _ in range(3)),
        )
        self.t1 = nn.ModuleList([_CBR(n, 256, 32), _CBR(n, 256, 64, strides=2)])
        self.b1 = nn.ModuleList([_branch(n, 32), _branch(n, 64)])
        self.fuse1 = _Fuse1(n)
        self.t2 = nn.ModuleList([_CBR(n, 32, 32), _CBR(n, 64, 64), _CBR(n, 64, 128, strides=2)])
        self.b2 = nn.ModuleList([_branch(n, 32), _branch(n, 64), _branch(n, 128)])
        self.fuse2 = _Fuse2(n)
        self.t3 = nn.ModuleList(
            [_CBR(n, 32, 32), _CBR(n, 64, 64), _CBR(n, 128, 128), _CBR(n, 128, 256, strides=2)]
        )
        self.b3 = nn.ModuleList([_branch(n, 32), _branch(n, 64), _branch(n, 128), _branch(n, 256)])
        self.fuse3 = _Fuse3(n)
        self.head = _CBR(n, 128, 64)
        self.out = L.Conv2d(n, 64, num_classes, 1, activation="softmax")

    def _stage1(self, y: torch.Tensor) -> List[torch.Tensor]:
        t = [self.t1[0](y), self.t1[1](y)]
        return self.fuse1([b(v) for b, v in zip(self.b1, t)])

    def _stage2(self, f0: torch.Tensor, f1: torch.Tensor) -> List[torch.Tensor]:
        t = [self.t2[0](f0), self.t2[1](f1), self.t2[2](f1)]
        return self.fuse2([b(v) for b, v in zip(self.b2, t)])

    def _stage3(self, f0: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
        t = [self.t3[0](f0), self.t3[1](f1), self.t3[2](f2), self.t3[3](f2)]
        return self.fuse3([b(v) for b, v in zip(self.b3, t)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the JAX model's remat stages end after layer1 and after each fusion
        y = L.stage(self, lambda v: self.layer1(self.stem(v)), x)
        f = L.stage(self, self._stage1, y)
        f = L.stage(self, self._stage2, *f)
        out = L.stage(self, self._stage3, *f)
        return L.stage(self, lambda v: self.out(self.head(L.upsample2d(v, 2))), out)
