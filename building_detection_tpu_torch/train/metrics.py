"""Segmentation metrics from argmax confusion counts.

The counterpart of ``building_detection_tpu/train/metrics.py``: PA, IoU,
MIoU and F1 over the binary argmax masks, each with ``K.epsilon() = 1e-7``
in its denominators.  An argmax tie resolves to the lowest index, as
``jnp.argmax`` does.  Under data parallelism the confusion counts are
all-reduced before the ratios are taken, as the JAX step computes them over
the global batch.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist

EPSILON = 1e-7


def _confusion(y_true: torch.Tensor, y_pred: torch.Tensor, group=None) -> Tuple[torch.Tensor, ...]:
    """``(tp, tn, fp, fn)`` as f32; under a data ``group`` the integer
    counts are summed over its ranks first, so the ratios are the global
    batch's (averaging each rank's ratios would not be)."""
    yt = torch.argmax(y_true[..., :2], dim=-1)  # first maximum on a tie
    yp = torch.argmax(y_pred, dim=-1)
    counts = torch.stack([
        torch.sum(yt * yp), torch.sum((1 - yt) * (1 - yp)), torch.sum((1 - yt) * yp), torch.sum(yt * (1 - yp))
    ])
    if group is not None:
        dist.all_reduce(counts, group=group)
    tp, tn, fp, fn = counts.float()
    return tp, tn, fp, fn


def pixel_accuracy(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    tp, tn, fp, fn = _confusion(y_true, y_pred)
    return (tp + tn) / (tp + tn + fp + fn + EPSILON)


def iou(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    tp, tn, fp, fn = _confusion(y_true, y_pred)
    return tp / (tp + fp + fn + EPSILON)


def miou(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    tp, tn, fp, fn = _confusion(y_true, y_pred)
    iou0 = tp / (tp + fp + fn + EPSILON)
    iou1 = tn / (tn + fp + fn + EPSILON)
    return (iou0 + iou1) / 2


def f1_score(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    tp, tn, fp, fn = _confusion(y_true, y_pred)
    recall = tp / (tp + fn + EPSILON)
    precision = tp / (tp + fp + EPSILON)
    return (2.0 * precision * recall) / (precision + recall + EPSILON)


def all_metrics(y_true: torch.Tensor, y_pred: torch.Tensor, group=None) -> Dict[str, torch.Tensor]:
    """All four from one confusion computation, as 0-d f32 tensors; over
    the global batch under a data ``group``."""
    tp, tn, fp, fn = _confusion(y_true, y_pred, group)
    iou0 = tp / (tp + fp + fn + EPSILON)
    iou1 = tn / (tn + fp + fn + EPSILON)
    recall = tp / (tp + fn + EPSILON)
    precision = tp / (tp + fp + EPSILON)
    return {
        "PA": (tp + tn) / (tp + tn + fp + fn + EPSILON),
        "IoU": iou0,
        "MIoU": (iou0 + iou1) / 2,
        "F1_score": (2.0 * precision * recall) / (precision + recall + EPSILON),
    }
