"""Xception-65-style DeepLabv3+ models, plain (v3plus) and with BAM (bam).

The counterpart of ``building_detection_tpu/models/xception_deeplab.py``.
Backbone at output stride 16: entry convs 32 (s2) and 64, three residual
separable-conv blocks at 128/256/728 with stride 2, a 16-block middle flow
at 728 channels, exit flow 1024/1536/1536/2048 at stride 1; the BAM variant
adds BAM after the entry convs, the 128 and 256 blocks and the middle flow.
Head: ASPP (1x1, 3x3 at d=6/12/18, image pooling) beside an SKNet block.
The two decoders differ and are kept as in the JAX package.
"""
from __future__ import annotations

from typing import List

import torch
from torch import nn

from building_detection_tpu_torch.core.module import Namer
from building_detection_tpu_torch.nn import layers as L
from building_detection_tpu_torch.nn.attention import BAMAttention, SCSEBlock, SKNetBlock


class _CBR(nn.Module):
    FOLDS = (("conv", "bn"),)  # nn/fold.py: the conv's output feeds the BN alone

    def __init__(self, namer: Namer, in_ch: int, filters: int, kernel: int, strides: int = 1,
                 activate: bool = True, dilation: int = 1):
        super().__init__()
        self.conv = L.Conv2d(namer, in_ch, filters, kernel, strides=strides, dilation=dilation)
        self.bn = L.BatchNorm(namer, filters)
        self.activate = activate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return L.relu(x) if self.activate else x


class _SepBN(nn.Module):
    """SeparableConv2D(3x3) + BN, with the ReLU in front when ``pre_relu``."""

    FOLDS = (("conv", "bn"),)  # nn/fold.py: the pointwise output feeds the BN alone

    def __init__(self, namer: Namer, in_ch: int, filters: int, strides: int = 1, pre_relu: bool = True):
        super().__init__()
        self.conv = L.SeparableConv2d(namer, in_ch, filters, 3, strides=strides)
        self.bn = L.BatchNorm(namer, filters)
        self.pre_relu = pre_relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(L.relu(x) if self.pre_relu else x))


class _EntryBlock(nn.Module):
    """Residual block with a strided 1x1 projection.  The first block
    (128) has no leading ReLU and ends in a SAME max-pool; the others end
    in a strided separable conv."""

    def __init__(self, namer: Namer, in_ch: int, ch: int, first: bool):
        super().__init__()
        self.residual = _CBR(namer, in_ch, ch, 1, strides=2, activate=False)
        self.first = first
        if first:
            self.seps = nn.Sequential(_SepBN(namer, in_ch, ch, pre_relu=False), _SepBN(namer, ch, ch))
        else:
            self.seps = nn.Sequential(
                _SepBN(namer, in_ch, ch), _SepBN(namer, ch, ch), _SepBN(namer, ch, ch, strides=2)
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = self.residual(x)
        y = self.seps(x)
        if self.first:
            y = L.max_pool(y, pool_size=3, strides=2, padding="SAME")
        return y + residual


class _MiddleBlock(nn.Module):
    def __init__(self, namer: Namer):
        super().__init__()
        self.seps = nn.Sequential(*(_SepBN(namer, 728, 728) for _ in range(3)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.seps(x) + x


class _Backbone(nn.Module):
    """Returns the pyramid ``[c, c1, c2, c3, c4, c5]``."""

    def __init__(self, namer: Namer, use_bam: bool):
        super().__init__()
        self.entry = nn.Sequential(_CBR(namer, 3, 32, 3, strides=2), _CBR(namer, 32, 64, 3))
        self.bam0 = BAMAttention(namer, 64) if use_bam else nn.Identity()
        self.block1 = _EntryBlock(namer, 64, 128, first=True)
        self.bam1 = BAMAttention(namer, 128) if use_bam else nn.Identity()
        self.block2 = _EntryBlock(namer, 128, 256, first=False)
        self.bam2 = BAMAttention(namer, 256) if use_bam else nn.Identity()
        self.block3 = _EntryBlock(namer, 256, 728, first=False)
        self.middle = nn.Sequential(*(_MiddleBlock(namer) for _ in range(16)))
        self.bam4 = BAMAttention(namer, 728) if use_bam else nn.Identity()
        self.exit_residual = _CBR(namer, 728, 1024, 1, activate=False)
        self.exit_seps = nn.Sequential(
            _SepBN(namer, 728, 728), _SepBN(namer, 728, 1024), _SepBN(namer, 1024, 1024)
        )
        self.exit_tail = nn.ModuleList(
            [_SepBN(namer, 1024, 1536, pre_relu=False), _SepBN(namer, 1536, 1536), _SepBN(namer, 1536, 2048)]
        )

    def _exit(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bam4(x)
        x = self.exit_seps(x) + self.exit_residual(x)
        for sep in self.exit_tail:
            x = sep(x)
        return L.relu(x)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        # remat stages: the JAX model tags c1, c2, c3, every fourth middle
        # block and c5; the entry convs run as a segment of their own
        c = x = L.stage(self, lambda v: self.bam0(self.entry(v)), x)
        c1 = x = L.stage(self, self.block1, x)
        c2 = x = L.stage(self, lambda v: self.block2(self.bam1(v)), x)
        c3 = x = L.stage(self, lambda v: self.block3(self.bam2(v)), x)
        for i in range(0, len(self.middle), 4):
            x = L.stage(self, self.middle[i : i + 4], x)
        c4 = x
        c5 = L.stage(self, self._exit, x)
        return [c, c1, c2, c3, c4, c5]


class _ASPP(nn.Module):
    """Atrous spatial pyramid pooling; image pooling is global average +
    1x1 conv + broadcast."""

    def __init__(self, namer: Namer, in_ch: int):
        super().__init__()
        self.conv = _CBR(namer, in_ch, 256, 1)
        self.atrous = nn.ModuleList(_CBR(namer, in_ch, 256, 3, dilation=d) for d in (6, 12, 18))
        self.pool = _CBR(namer, in_ch, 256, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = [a(x) for a in self.atrous]
        gp = self.pool(L.global_avg_pool(x, keepdims=True)).expand_as(p[0])
        return torch.cat([self.conv(x), *p, gp], dim=-1)


class _Head(nn.Module):
    """ASPP beside SKNet, concatenated and refined."""

    def __init__(self, namer: Namer):
        super().__init__()
        self.sk = SKNetBlock(namer, 2048)
        self.aspp = _ASPP(namer, 2048)
        self.project = _CBR(namer, 5 * 256, 256, 1)
        self.refine = nn.Sequential(_CBR(namer, 512, 256, 3), _CBR(namer, 256, 256, 3))
        self.scse = SCSEBlock(namer, 256)

    def forward(self, c5: torch.Tensor) -> torch.Tensor:
        sk = self.sk(c5)
        y = self.project(self.aspp(c5))
        return self.scse(self.refine(torch.cat([y, sk], dim=-1)))


class _Refine(nn.Module):
    """Two 3x3 conv-BN-ReLU and an scSE block."""

    def __init__(self, namer: Namer, in_ch: int, ch: int):
        super().__init__()
        self.convs = nn.Sequential(_CBR(namer, in_ch, ch, 3), _CBR(namer, ch, ch, 3))
        self.scse = SCSEBlock(namer, ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.scse(self.convs(x))


class DeepLabV3P(nn.Module):
    """Plain Xception-DeepLabv3+."""

    def __init__(self, num_classes: int = 2):
        super().__init__()
        n = Namer()
        self.backbone = _Backbone(n, use_bam=False)
        self.head = _Head(n)
        self.dec1 = _Refine(n, 512, 256)
        self.up2 = L.Conv2dTranspose(n, 256, 128, 3, strides=2)
        self.dec2 = _Refine(n, 256, 128)
        self.up3 = L.Conv2dTranspose(n, 128, 64, 3, strides=2)
        self.dec3 = _Refine(n, 128, 64)
        self.dec4 = nn.Sequential(_CBR(n, 64, 32, 3), _CBR(n, 32, 32, 3))
        self.out = L.Conv2d(n, 32, num_classes, 1, activation="softmax")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c, c1, c2, _, _, c5 = self.backbone(x)
        # remat stages: the head and each decoder level up to its scSE gate
        y = L.stage(self, self.head, c5)
        y = L.stage(self, lambda v, s: self.dec1(torch.cat([L.upsample2d(v, 2), s], dim=-1)), y, c2)
        y = L.stage(self, lambda v, s: self.dec2(torch.cat([self.up2(v), s], dim=-1)), y, c1)
        y = L.stage(self, lambda v, s: self.dec3(torch.cat([s, self.up3(v)], dim=-1)), y, c)
        return L.stage(self, lambda v: self.out(self.dec4(L.upsample2d(v, 2))), y)


class DeepLabV3PBAM(nn.Module):
    """BAM-augmented Xception-DeepLabv3+."""

    def __init__(self, num_classes: int = 2):
        super().__init__()
        n = Namer()
        self.backbone = _Backbone(n, use_bam=True)
        self.head = _Head(n)
        self.dec1 = _Refine(n, 512, 128)
        self.dec2 = _Refine(n, 256, 64)
        self.out = L.Conv2d(n, 64, num_classes, 1, activation="softmax")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, c1, c2, _, _, c5 = self.backbone(x)
        # remat stages: the head and each decoder level up to its scSE gate
        y = L.stage(self, self.head, c5)
        y = L.stage(self, lambda v, s: self.dec1(torch.cat([s, L.upsample2d(v, 2)], dim=-1)), y, c2)
        y = L.stage(self, lambda v, s: self.dec2(torch.cat([s, L.upsample2d(v, 2)], dim=-1)), y, c1)
        return L.stage(self, lambda v: self.out(L.upsample2d(v, 4)), y)
