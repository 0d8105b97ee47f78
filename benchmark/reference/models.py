"""The five members in plain float32 PyTorch: the benchmark's reference.

A frozen copy of the architectures of the reference repository
(A511-1103/building-detection, ``predict_model/*.py``) as the program's
``models/*.py`` and ``nn/attention.py`` build them, layer for layer and in
the same construction order, so the Keras names agree.  (B, H, W, 3) in
[-1, 1] -> (B, H, W, 2) softmax, for H and W divisible by 16.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import torch
from torch import nn

from benchmark.reference import layers as L


# -- attention blocks ------------------------------------------------------------
class SEBlock(nn.Module):
    def __init__(self, n, ch):
        super().__init__()
        self.dense1 = L.Dense(n, ch, ch // 2)
        self.bn1 = L.BatchNorm(n, ch // 2)
        self.dense2 = L.Dense(n, ch // 2, ch)
        self.bn2 = L.BatchNorm(n, ch)

    def forward(self, x):
        f = torch.relu(self.bn1(self.dense1(L.global_avg_pool(x))))
        f = torch.sigmoid(self.bn2(self.dense2(f)))
        return x * f[:, None, None, :]


class SCSEBlock(nn.Module):
    def __init__(self, n, ch):
        super().__init__()
        self.sse = L.Conv2d(n, ch, 1, 1, activation="sigmoid")
        self.cse1 = L.Conv2d(n, ch, ch // 16, 1)
        self.cse2 = L.Conv2d(n, ch // 16, ch, 1)

    def forward(self, x):
        channel = torch.sigmoid(self.cse2(self.cse1(L.global_avg_pool(x, keepdims=True))))
        return self.sse(x) * x + channel * x


class BAMAttention(nn.Module):
    """``x * sigmoid(channel gate + spatial gate) + x``, reduction 16,
    spatial dilation 4."""

    def __init__(self, n, ch, rate=16, d=4):
        super().__init__()
        mid = ch // rate
        self.c_dense1 = L.Dense(n, ch, mid)
        self.c_bn1 = L.BatchNorm(n, mid)
        self.c_dense2 = L.Dense(n, mid, mid)
        self.c_bn2 = L.BatchNorm(n, mid)
        self.c_dense3 = L.Dense(n, mid, ch)
        self.s_conv1 = L.Conv2d(n, ch, mid, 1)
        self.s_bn1 = L.BatchNorm(n, mid)
        self.s_conv2 = L.Conv2d(n, mid, mid, 3, dilation=d)
        self.s_bn2 = L.BatchNorm(n, mid)
        self.s_conv3 = L.Conv2d(n, mid, mid, 3, dilation=d)
        self.s_bn3 = L.BatchNorm(n, mid)
        self.s_conv4 = L.Conv2d(n, mid, 1, 1)

    def forward(self, x):
        c = torch.relu(self.c_bn1(self.c_dense1(L.global_avg_pool(x))))
        c = self.c_dense3(torch.relu(self.c_bn2(self.c_dense2(c))))
        s = torch.relu(self.s_bn1(self.s_conv1(x)))
        s = torch.relu(self.s_bn2(self.s_conv2(s)))
        s = self.s_conv4(torch.relu(self.s_bn3(self.s_conv3(s))))
        return x * torch.sigmoid(c[:, None, None, :] + s) + x


class CBR(nn.Module):
    """Conv, BN and (optionally) ReLU."""

    def __init__(self, n, in_ch, filters, kernel=3, strides=1, activate=True, dilation=1, name=None):
        super().__init__()
        self.conv = L.Conv2d(n, in_ch, filters, kernel, strides=strides, dilation=dilation, name=name)
        self.bn = L.BatchNorm(n, filters, name=None if name is None else f"{name}_BN")
        self.activate = activate

    def forward(self, x):
        x = self.bn(self.conv(x))
        return torch.relu(x) if self.activate else x


class SKNetBlock(nn.Module):
    def __init__(self, n, in_ch, reduce=16):
        super().__init__()
        ch = 256
        self.stem = CBR(n, in_ch, ch, 3)
        self.branches = nn.ModuleList(CBR(n, ch, ch, 1 if d == 1 else 3, dilation=d) for d in (1, 6, 12, 18))
        self.gap = CBR(n, ch, ch, 1)
        self.squeeze = CBR(n, ch, ch // reduce, 1)
        self.heads = nn.ModuleList(L.Conv2d(n, ch // reduce, ch, 1) for _ in range(5))
        self.bn = L.BatchNorm(n, ch)

    def forward(self, x):
        conv = self.stem(x)
        branches = [b(conv) for b in self.branches]
        branches.append(self.gap(L.global_avg_pool(conv, keepdims=True)).expand_as(conv))
        z = self.squeeze(L.global_avg_pool(sum(branches), keepdims=True))
        weights = torch.softmax(torch.stack([h(z) for h in self.heads], dim=1), dim=1)
        fused = sum(b * weights[:, i] for i, b in enumerate(branches))
        return torch.relu(self.bn(fused))


# -- res34 U-Net -------------------------------------------------------------------
class _Res(nn.Module):
    def __init__(self, n, ch, name):
        super().__init__()
        self.a = CBR(n, ch, ch, 3, name=f"{name}_1")
        self.b = CBR(n, ch, ch, 3, name=f"{name}_2")

    def forward(self, x):
        return torch.relu(x + self.b(self.a(x)))


class Res34UNet(nn.Module):
    """ResNet-34 encoder (stem 3 x conv64, strided 1x1 ``pool`` convs,
    stages [3, 4, 6, 3] at 64-512), two low-to-high aggregations, SE on the
    five levels, four ConvT decoder stages, conv64 -> conv2 softmax."""

    def __init__(self):
        super().__init__()
        n, f = L.Namer(), 64
        self.stem = nn.Sequential(*(CBR(n, 3 if i == 1 else f, f, 3, name=f"conv1_{i}") for i in (1, 2, 3)))
        self.stages = nn.ModuleList()
        in_ch = f
        for level, (ch, blocks) in enumerate(((f, 3), (f * 2, 4), (f * 4, 6), (f * 8, 3))):
            pool = L.Conv2d(n, in_ch, ch, 1, strides=2, name=f"pool{level + 1}")
            self.stages.append(nn.Sequential(pool, *(_Res(n, ch, f"conv{level + 2}_{i}") for i in range(blocks))))
            in_ch = ch
        # low-to-high aggregation: (low, mid, high) channels (64, 64, 128), then (128, 256, 256)
        self.l2h = nn.ModuleList()
        for low, mid, high in ((f, f, f * 2), (f + f, f * 2 + f + f, f * 4)):
            self.l2h.append(nn.ModuleList([
                L.Conv2d(n, high + mid + low, high + mid + low, 1, activation="relu"),
                L.Conv2d(n, mid + low, mid + low, 1, activation="relu"),
            ]))
        chans = (f, 2 * f, 6 * f, 10 * f, 8 * f)  # 64, 128, 384, 640, 512 after the aggregations
        self.se = nn.ModuleList(SEBlock(n, ch) for ch in chans)
        self.ups = nn.ModuleList()
        high_ch = chans[4]
        for level in (3, 2, 1, 0):
            low_ch = chans[level]
            self.ups.append(nn.ModuleList([
                L.Conv2dTranspose(n, high_ch, low_ch, 2, strides=2, activation="relu"),
                L.Conv2d(n, 2 * low_ch, low_ch, 1, activation="relu"),
                _Res(n, low_ch, f"upsame_{level + 1}"),
            ]))
            high_ch = low_ch
        self.head1 = L.Conv2d(n, f, 64, 3, activation="relu")
        self.head2 = L.Conv2d(n, 64, 2, 3, activation="softmax")

    def forward(self, x):
        c = [self.stem(x)]
        for stage in self.stages:
            c.append(stage(c[-1]))
        for i, (high, mid) in enumerate(self.l2h):
            low_, mid_, high_ = c[i], c[i + 1], c[i + 2]
            high_out = high(torch.cat([high_, L.max_pool(mid_), L.max_pool(low_, 2, 4)], dim=-1))
            mid_out = mid(torch.cat([mid_, L.max_pool(low_)], dim=-1))
            c[i + 1], c[i + 2] = mid_out, high_out
        feats = [se(v) for se, v in zip(self.se, c)]
        y = feats[4]
        for (up, conv, res), low in zip(self.ups, (feats[3], feats[2], feats[1], feats[0])):
            y = res(conv(torch.cat([low, up(y)], dim=-1)))
        return self.head2(self.head1(y))


# -- scSE U-Net -----------------------------------------------------------------------
def _double(n, in_ch, ch):
    return nn.Sequential(L.Conv2d(n, in_ch, ch, 3, activation="relu"), L.Conv2d(n, ch, ch, 3, activation="relu"))


class SCSEUNet(nn.Module):
    """Encoder 64-1024 of double 3x3 convs and max pools (no BN), ConvT
    decoder with an scSE block after every stage, 1x1 softmax head."""

    def __init__(self):
        super().__init__()
        n = L.Namer()
        widths = (64, 128, 256, 512, 1024)
        self.down = nn.ModuleList()
        in_ch = 3
        for ch in widths:
            self.down.append(_double(n, in_ch, ch))
            in_ch = ch
        self.up = nn.ModuleList()
        for ch in reversed(widths[:-1]):
            self.up.append(nn.ModuleList([
                L.Conv2dTranspose(n, in_ch, ch, 3, strides=2, activation="relu"),
                _double(n, 2 * ch, ch),
                SCSEBlock(n, ch),
            ]))
            in_ch = ch
        self.head = L.Conv2d(n, in_ch, 2, 1, activation="softmax")

    def forward(self, x):
        skips = [self.down[0](x)]
        for stage in self.down[1:]:
            skips.append(stage(L.max_pool(skips[-1])))
        y = skips.pop()
        for up, conv, scse in self.up:
            y = scse(conv(torch.cat([up(y), skips.pop()], dim=-1)))
        return self.head(y)


# -- HRNet ----------------------------------------------------------------------------
class _Bottleneck(nn.Module):
    def __init__(self, n, in_ch, filters, project):
        super().__init__()
        q = filters // 4
        self.body = nn.Sequential(CBR(n, in_ch, q, 1), CBR(n, q, q, 3), CBR(n, q, filters, 1, activate=False))
        self.short = CBR(n, in_ch, filters, 1, activate=False) if project else None

    def forward(self, x):
        return torch.relu(self.body(x) + (x if self.short is None else self.short(x)))


class _Basic(nn.Module):
    def __init__(self, n, ch):
        super().__init__()
        self.a = CBR(n, ch, ch, 3)
        self.b = CBR(n, ch, ch, 3, activate=False)

    def forward(self, x):
        return torch.relu(self.b(self.a(x)) + x)


def _branch(n, ch):
    return nn.Sequential(*(_Basic(n, ch) for _ in range(4)))


class HRNet(nn.Module):
    """Stem conv64 s2, layer1 (4 bottlenecks at 256), branches at 32/64/128/256
    spawned by three transitions with four basic blocks each and fused
    across resolutions, x2 upsample, conv64, 1x1 softmax."""

    def __init__(self):
        super().__init__()
        n = L.Namer()
        self.stem = CBR(n, 3, 64, strides=2)
        self.layer1 = nn.Sequential(_Bottleneck(n, 64, 256, True), *(_Bottleneck(n, 256, 256, False) for _ in range(3)))
        self.t1 = nn.ModuleList([CBR(n, 256, 32), CBR(n, 256, 64, strides=2)])
        self.b1 = nn.ModuleList([_branch(n, 32), _branch(n, 64)])
        self.f1_up = CBR(n, 64, 32, 1, activate=False)
        self.f1_down = CBR(n, 32, 64, 3, strides=2, activate=False)
        self.t2 = nn.ModuleList([CBR(n, 32, 32), CBR(n, 64, 64), CBR(n, 64, 128, strides=2)])
        self.b2 = nn.ModuleList([_branch(n, 32), _branch(n, 64), _branch(n, 128)])
        self.c12 = CBR(n, 64, 32, 1, activate=False)
        self.c13 = CBR(n, 128, 32, 1, activate=False)
        self.c21 = CBR(n, 32, 64, 3, 2, activate=False)
        self.c23 = CBR(n, 128, 64, 1, activate=False)
        self.c31a = CBR(n, 32, 32, 3, 2)
        self.c31b = CBR(n, 32, 128, 3, 2, activate=False)
        self.c32 = CBR(n, 64, 128, 3, 2, activate=False)
        self.t3 = nn.ModuleList([CBR(n, 32, 32), CBR(n, 64, 64), CBR(n, 128, 128), CBR(n, 128, 256, strides=2)])
        self.b3 = nn.ModuleList([_branch(n, 32), _branch(n, 64), _branch(n, 128), _branch(n, 256)])
        self.f3 = nn.ModuleList(CBR(n, ch, 32, 1, activate=False) for ch in (64, 128, 256))
        self.head = CBR(n, 128, 64)
        self.out = L.Conv2d(n, 64, 2, 1, activation="softmax")

    def forward(self, x):
        y = self.layer1(self.stem(x))
        a, b = (br(t(y)) for br, t in zip(self.b1, self.t1))
        a, b = a + L.upsample2d(self.f1_up(b), 2), self.f1_down(a) + b
        x0, x1, x2 = (br(t(v)) for br, t, v in zip(self.b2, self.t2, (a, b, b)))
        a = x0 + L.upsample2d(self.c12(x1), 2) + L.upsample2d(self.c13(x2), 4)
        b = self.c21(x0) + x1 + L.upsample2d(self.c23(x2), 2)
        c = self.c31b(self.c31a(x0)) + self.c32(x1) + x2
        v = [br(t(u)) for br, t, u in zip(self.b3, self.t3, (a, b, c, c))]
        out = torch.cat([v[0]] + [L.upsample2d(f(u), 2 ** (i + 1)) for i, (f, u) in enumerate(zip(self.f3, v[1:]))], -1)
        return self.out(self.head(L.upsample2d(out, 2)))


# -- Xception DeepLabV3+ (v3plus) and with BAM (bam) ------------------------------------
class _SepBN(nn.Module):
    def __init__(self, n, in_ch, filters, strides=1, pre_relu=True):
        super().__init__()
        self.conv = L.SeparableConv2d(n, in_ch, filters, 3, strides=strides)
        self.bn = L.BatchNorm(n, filters)
        self.pre_relu = pre_relu

    def forward(self, x):
        return self.bn(self.conv(torch.relu(x) if self.pre_relu else x))


class _Entry(nn.Module):
    def __init__(self, n, in_ch, ch, first):
        super().__init__()
        self.residual = CBR(n, in_ch, ch, 1, strides=2, activate=False)
        self.first = first
        if first:
            self.seps = nn.Sequential(_SepBN(n, in_ch, ch, pre_relu=False), _SepBN(n, ch, ch))
        else:
            self.seps = nn.Sequential(_SepBN(n, in_ch, ch), _SepBN(n, ch, ch), _SepBN(n, ch, ch, strides=2))

    def forward(self, x):
        r = self.residual(x)
        y = self.seps(x)
        if self.first:
            y = L.max_pool(y, 3, 2, "SAME")
        return y + r


class _Backbone(nn.Module):
    """Xception-65 at output stride 16; returns ``[c, c1, c2, c5]``."""

    def __init__(self, n, bam):
        super().__init__()
        ident = nn.Identity
        self.entry = nn.Sequential(CBR(n, 3, 32, 3, strides=2), CBR(n, 32, 64, 3))
        self.bam0 = BAMAttention(n, 64) if bam else ident()
        self.block1 = _Entry(n, 64, 128, True)
        self.bam1 = BAMAttention(n, 128) if bam else ident()
        self.block2 = _Entry(n, 128, 256, False)
        self.bam2 = BAMAttention(n, 256) if bam else ident()
        self.block3 = _Entry(n, 256, 728, False)
        self.middle = nn.ModuleList(nn.Sequential(*(_SepBN(n, 728, 728) for _ in range(3))) for _ in range(16))
        self.bam4 = BAMAttention(n, 728) if bam else ident()
        self.exit_residual = CBR(n, 728, 1024, 1, activate=False)
        self.exit_seps = nn.Sequential(_SepBN(n, 728, 728), _SepBN(n, 728, 1024), _SepBN(n, 1024, 1024))
        self.exit_tail = nn.Sequential(
            _SepBN(n, 1024, 1536, pre_relu=False), _SepBN(n, 1536, 1536), _SepBN(n, 1536, 2048)
        )

    def forward(self, x) -> List[torch.Tensor]:
        c = self.bam0(self.entry(x))
        c1 = self.block1(c)
        c2 = self.block2(self.bam1(c1))
        y = self.block3(self.bam2(c2))
        for block in self.middle:
            y = block(y) + y
        y = self.bam4(y)
        y = self.exit_seps(y) + self.exit_residual(y)
        return [c, c1, c2, torch.relu(self.exit_tail(y))]


class _Head(nn.Module):
    """ASPP (1x1, 3x3 at d=6/12/18, image pooling) beside SKNet, projected,
    refined and gated by scSE."""

    def __init__(self, n):
        super().__init__()
        self.sk = SKNetBlock(n, 2048)
        self.aspp_conv = CBR(n, 2048, 256, 1)
        self.aspp_atrous = nn.ModuleList(CBR(n, 2048, 256, 3, dilation=d) for d in (6, 12, 18))
        self.aspp_pool = CBR(n, 2048, 256, 1)
        self.project = CBR(n, 5 * 256, 256, 1)
        self.refine = nn.Sequential(CBR(n, 512, 256, 3), CBR(n, 256, 256, 3))
        self.scse = SCSEBlock(n, 256)

    def forward(self, c5):
        sk = self.sk(c5)
        atrous = [a(c5) for a in self.aspp_atrous]
        pooled = self.aspp_pool(L.global_avg_pool(c5, keepdims=True)).expand_as(atrous[0])
        y = self.project(torch.cat([self.aspp_conv(c5), *atrous, pooled], dim=-1))
        return self.scse(self.refine(torch.cat([y, sk], dim=-1)))


class _Refine(nn.Module):
    def __init__(self, n, in_ch, ch):
        super().__init__()
        self.convs = nn.Sequential(CBR(n, in_ch, ch, 3), CBR(n, ch, ch, 3))
        self.scse = SCSEBlock(n, ch)

    def forward(self, x):
        return self.scse(self.convs(x))


class DeepLabV3P(nn.Module):
    def __init__(self):
        super().__init__()
        n = L.Namer()
        self.backbone = _Backbone(n, bam=False)
        self.head = _Head(n)
        self.dec1 = _Refine(n, 512, 256)
        self.up2 = L.Conv2dTranspose(n, 256, 128, 3, strides=2)
        self.dec2 = _Refine(n, 256, 128)
        self.up3 = L.Conv2dTranspose(n, 128, 64, 3, strides=2)
        self.dec3 = _Refine(n, 128, 64)
        self.dec4 = nn.Sequential(CBR(n, 64, 32, 3), CBR(n, 32, 32, 3))
        self.out = L.Conv2d(n, 32, 2, 1, activation="softmax")

    def forward(self, x):
        c, c1, c2, c5 = self.backbone(x)
        y = self.head(c5)
        y = self.dec1(torch.cat([L.upsample2d(y, 2), c2], dim=-1))
        y = self.dec2(torch.cat([self.up2(y), c1], dim=-1))
        y = self.dec3(torch.cat([c, self.up3(y)], dim=-1))
        return self.out(self.dec4(L.upsample2d(y, 2)))


class DeepLabV3PBAM(nn.Module):
    def __init__(self):
        super().__init__()
        n = L.Namer()
        self.backbone = _Backbone(n, bam=True)
        self.head = _Head(n)
        self.dec1 = _Refine(n, 512, 128)
        self.dec2 = _Refine(n, 256, 64)
        self.out = L.Conv2d(n, 64, 2, 1, activation="softmax")

    def forward(self, x):
        _, c1, c2, c5 = self.backbone(x)
        y = self.head(c5)
        y = self.dec1(torch.cat([c2, L.upsample2d(y, 2)], dim=-1))
        y = self.dec2(torch.cat([c1, L.upsample2d(y, 2)], dim=-1))
        return self.out(L.upsample2d(y, 4))


MODELS: Dict[str, Callable[[], nn.Module]] = {
    "res34": Res34UNet,
    "hrnet": HRNet,
    "v3plus": DeepLabV3P,
    "scse": SCSEUNet,
    "bam": DeepLabV3PBAM,
}


def build(name: str, device=None) -> nn.Module:
    """The named member with empty tensors on ``device``, in eval mode."""
    with torch.device(device or "cpu"):
        return MODELS[name]().eval()
