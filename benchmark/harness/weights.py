"""Seeded member weights, made on the device in Keras layout.

Every tensor of a member (the names and Keras shapes come from the
benchmark's reference model, :mod:`benchmark.reference.models`) is cut from
one normal draw and one uniform draw of a ``torch.Generator`` on the device:

* kernels: He normal, ``std = sqrt(2 / fan_in)`` with ``fan_in`` the product
  of every axis but the last (a depthwise kernel's is its window); a kernel
  with two outputs (a class head) has the mean over its input channels taken
  out of each tap, so both classes see the features alike and neither wins
  everywhere;
* biases: ``0.1 * N(0, 1)``; BN gammas ``1 + 0.1 * N(0, 1)`` and betas
  ``1 + 0.1 * N(0, 1)``: with zero-mean betas half of every ReLU is off and
  the random members are chaotic (a 0.2 % change of the input moved hrnet's
  logits by 37 % on the CPU, and bf16 rounding flipped 16 % of its mask
  bits), which no trained member is; with the inputs of most ReLUs above
  0 the same change moves them by 1-2 %;
* BN moving means ``0.1 * N(0, 1)``, moving variances ``U(0.5, 1.5)``.

:func:`calibrate_bn` then replaces the moving statistics by those of one
train-mode forward over a calibration batch, as training would leave them,
so activations stay near unit scale through the residual stacks in eval
mode (the plain draw grows them to 1e10 in the Xception members).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from benchmark.reference import layers as RL

Weights = Dict[str, torch.Tensor]


def make(model: nn.Module, seed: int, device) -> Weights:
    """``{keras key: f32 tensor in Keras layout}`` for ``model`` from ``seed``."""
    tensors = RL.keras_tensors(model)
    total = sum(math.prod(shape) for _, shape, _ in tensors.values())
    g = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(total, generator=g, device=device)
    uniform = torch.rand(total, generator=g, device=device)
    out: Weights = {}
    at = 0
    for key, (_, shape, role) in tensors.items():
        size = math.prod(shape)
        z, u = normal[at : at + size].view(shape), uniform[at : at + size].view(shape)
        at += size
        if role in ("kernel", "depthwise"):
            w = z * math.sqrt(2.0 / math.prod(shape[:-1]))
            if shape[-1] == 2 and len(shape) == 4:
                w = w - w.mean(dim=-2, keepdim=True)
        elif role in ("gamma", "beta"):
            w = 1.0 + 0.1 * z
        elif role == "moving_variance":
            w = 0.5 + u
        else:  # bias, moving_mean
            w = 0.1 * z
        out[key] = w.clone()
    return out


@torch.no_grad()
def calibrate_bn(model: nn.Module, weights: Weights, batch: torch.Tensor) -> Weights:
    """``weights`` with every BN's moving statistics set to those of a
    train-mode forward of ``model`` (loaded with ``weights``) over the
    normalized ``batch``; ``model`` is left in eval mode."""
    RL.load_keras(model, weights)
    bns = [m for m in RL.layers(model) if isinstance(m, RL.BatchNorm)]
    for bn in bns:
        bn.momentum = 0.0
    model.train()
    model(batch)
    model.eval()
    for bn in bns:
        bn.momentum = 0.99
    out = dict(weights)
    for bn in bns:
        out[f"{bn.keras_name}/moving_mean"] = bn.moving_mean.clone()
        out[f"{bn.keras_name}/moving_variance"] = bn.moving_variance.clone()
    return out


def to_host(weights: Weights) -> Weights:
    return {k: v.detach().to("cpu") for k, v in weights.items()}


def to_device(weights: Weights, device) -> Weights:
    return {k: v.to(device) for k, v in weights.items()}
