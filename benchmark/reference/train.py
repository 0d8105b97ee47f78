"""The reference training step in plain float32: targets, loss and Keras Adam.

After the reference repository's ``train_model/res34.py``:

* targets: the one-hot class of ``label / 255 == 1``, and the two edge
  bands, inner ``label - erode(label) == 1`` and outer ``dilate(label) -
  label == 1``, each weighted 2 (else 1), over a 3x3 flat kernel applied 5
  times, which is one 11x11 window, the border counting as the identity;
* loss: ``-mean(sum_c w_c * edge * y * (1 - p)^2 * log(p + 1e-7))`` with
  class weights (0.35, 0.65), the outer band weighting class 0 (the ground
  just outside a building) and the inner band class 1;
* Keras Adam: ``m = 0.9 m + 0.1 g``, ``v = 0.999 v + 0.001 g^2``, ``p -=
  lr * sqrt(1 - 0.999^t) / (1 - 0.9^t) * m / (sqrt(v) + 1e-7)``;
* the learning rate: linear warmup from 1e-5 to 1e-3 over 3 epochs, then a
  half cosine to 0 at 30 epochs, evaluated at the update count before it
  is applied.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import layers as RL
from benchmark.reference.tiler import normalize

CLASS_WEIGHTS = (0.35, 0.65)
EDGE_WEIGHT, EDGE_WINDOW = 2.0, 11
B1, B2, EPS = 0.9, 0.999, 1e-7


def _window_max(x: torch.Tensor, k: int) -> torch.Tensor:
    pad = (k - 1) // 2
    y = F.pad(x[:, None], (pad, pad, pad, pad), value=float("-inf"))
    return F.max_pool2d(y, k, stride=1)[:, 0]


def targets(labels_u8: torch.Tensor) -> torch.Tensor:
    """(N, H, W) uint8 {0, 255} -> (N, H, W, 4): one-hot, outer band, inner band."""
    label = labels_u8.float() / 255.0
    one = (label == 1.0).float()
    inner = torch.where(label + _window_max(-label, EDGE_WINDOW) == 1.0, EDGE_WEIGHT, 1.0)
    outer = torch.where(_window_max(label, EDGE_WINDOW) - label == 1.0, EDGE_WEIGHT, 1.0)
    return torch.stack([1.0 - one, one, outer, inner], dim=-1)


def loss(y: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    w = torch.tensor(CLASS_WEIGHTS, dtype=p.dtype, device=p.device)
    term = w * y[..., 2:4] * y[..., :2] * (1 - p) ** 2 * torch.log(p + 1e-7)
    return -term.sum(dim=-1).mean()


def learning_rate(step: int, steps_per_epoch: int, epochs=30, warmup_epochs=3, base=1e-3, warmup=1e-5) -> float:
    total, warm = epochs * steps_per_epoch, warmup_epochs * steps_per_epoch
    if step < warm:
        return warmup + (base - warmup) * step / warm
    return 0.5 * base * (1 + math.cos(math.pi * (step - warm) / max(total - warm, 1)))


class Adam:
    def __init__(self, params: Dict[str, torch.Tensor]):
        self.params = params
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float) -> None:
        self.t += 1
        lr_t = lr * math.sqrt(1 - B2**self.t) / (1 - B1**self.t)
        for k, p in self.params.items():
            g = grads[k]
            self.m[k] = B1 * self.m[k] + (1 - B1) * g
            self.v[k] = B2 * self.v[k] + (1 - B2) * g * g
            p -= lr_t * self.m[k] / (self.v[k].sqrt() + EPS)


def steps(model: nn.Module, images: List[torch.Tensor], labels: List[torch.Tensor], steps_per_epoch: int,
          first_step: int = 0) -> Dict:
    """Train ``model`` (loaded, on the data's device) one step a batch.
    Returns the loss of each step, the gradient norm of every parameter at
    the first step, and the model's tensors after the last step."""
    named = {f"{layer.keras_name}/{leaf}": getattr(layer, leaf)
             for layer in RL.layers(model) for leaf in layer.keras_shapes}
    params = {k: t for k, t in named.items() if isinstance(t, nn.Parameter)}
    opt = Adam(params)
    model.train()
    losses, first_grads = [], None
    for i, (img, lab) in enumerate(zip(images, labels)):
        value = loss(targets(lab), model(normalize(img)))
        grads = dict(zip(params, torch.autograd.grad(value, list(params.values()), materialize_grads=True)))
        if first_grads is None:
            first_grads = {k: float(g.norm()) for k, g in grads.items()}
        opt.step(grads, learning_rate(first_step + i, steps_per_epoch))
        losses.append(float(value.detach()))
    return {"loss": np.array(losses), "grad_norms": first_grads,
            "tensors": {k: t.detach().clone() for k, t in named.items()}}
