"""Operation and byte counts of the work a cell asks for, and the peaks they are held to.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
power limit): 989 TFLOP/s in bf16, 3.35 TB/s of HBM3.  A card set to a
lower ``power.limit`` reaches less; the harness prints the limit beside
every share of a peak.

* A member's forward: the multiply-adds of its convolutions and dense
  products, two operations each, over one ``(1, tile, tile, 3)`` input,
  counted by ``torch.utils.flop_counter.FlopCounterMode`` on meta tensors
  through the benchmark's reference model (elementwise work, BN, pooling
  and the gates are not counted, so a share of the peak reads low).
* A training step: the same count over the forward and the backward that
  makes every parameter's gradient (the first layer's input gradient is
  not made), one image.
* The edge bands of ``make_targets``: the f32 label read once and two f32
  maps written once, ``12 * n * h * w`` bytes.

The configurations freeze these counts; the tests count them again.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import models as RM

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def forward_flops(member: str, tile: int) -> int:
    model = RM.build(member, "meta")
    x = torch.empty((1, tile, tile, 3), device="meta")
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(x)
    return int(counter.get_total_flops())


def train_flops(member: str, tile: int) -> int:
    model = RM.build(member, "meta").train()
    x = torch.empty((1, tile, tile, 3), device="meta")
    params = list(model.parameters())
    with FlopCounterMode(display=False) as counter:
        torch.autograd.grad(model(x).sum(), params)
    return int(counter.get_total_flops())


def edge_bytes(n: int, h: int, w: int) -> int:
    return 12 * n * h * w
