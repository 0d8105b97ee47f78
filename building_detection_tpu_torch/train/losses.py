"""Losses with the TF reference's semantics.

The counterpart of ``building_detection_tpu/train/losses.py``.  All three
take softmax *probabilities* (every member ends in softmax) and ``y_true``
of shape ``(N, H, W, 2)`` or ``(N, H, W, 4)``, channels 2:4 being the
(f_edge, p_edge) weight bands of :func:`train.trainer.make_targets`.  The
math is kept literal, ``log(p + K.epsilon())`` with ``K.epsilon() = 1e-7``.
"""
from __future__ import annotations

from typing import Tuple

import torch

EPSILON = 1e-7  # K.epsilon()


def binary_crossentropy(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    y = y_true[..., :2]
    loss = y * torch.log(y_pred + EPSILON)
    return -torch.mean(torch.sum(loss, dim=-1))


def focal_loss(
    y_true: torch.Tensor, y_pred: torch.Tensor, alpha: Tuple[float, float] = (0.5, 0.5)
) -> torch.Tensor:
    """gamma = 2, as the squared ``(1 - p)`` factor."""
    y = y_true[..., :2]
    w = torch.tensor(alpha, dtype=y_pred.dtype, device=y_pred.device)
    loss = w * y * (1 - y_pred) * (1 - y_pred) * torch.log(y_pred + EPSILON)
    return -torch.mean(torch.sum(loss, dim=-1))


def edge_focal_loss(
    y_true: torch.Tensor,
    y_pred: torch.Tensor,
    class_weights: Tuple[float, float] = (0.35, 0.65),
) -> torch.Tensor:
    """Class weights x edge-band weights x focal: the loss the reference
    trains with."""
    y = y_true[..., :2]
    edge_w = y_true[..., 2:4]
    w = torch.tensor(class_weights, dtype=y_pred.dtype, device=y_pred.device)
    loss = w * edge_w * y * (1 - y_pred) * (1 - y_pred) * torch.log(y_pred + EPSILON)
    return -torch.mean(torch.sum(loss, dim=-1))


LOSSES = {
    "binary_crossentropy": binary_crossentropy,
    "focal_loss": focal_loss,
    "edge_focal_loss": edge_focal_loss,
}
