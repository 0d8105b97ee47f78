"""Training targets.  The counterpart of ``make_targets`` in
``building_detection_tpu/train/trainer.py``; the rest of the trainer is not
ported yet."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from building_detection_tpu.core.config import TrainConfig
from building_detection_tpu_torch.ops.morphology import edge_weight_maps


def make_targets(
    labels_u8: torch.Tensor,
    cfg: TrainConfig = TrainConfig(),
    label_smooth: Optional[Tuple[float, float]] = None,
) -> torch.Tensor:
    """uint8 {0,255} labels ``(N, H, W)`` -> ``(N, H, W, 4)`` y_true on the
    labels' device: the one-hot class by an exact-1.0 test (``to_categorical``
    truncates), then the f_edge and p_edge bands from the 3x3 x5 erosion and
    dilation.  ``label_smooth=(pos, neg)`` maps one-hot 1 -> pos, 0 -> neg."""
    label = labels_u8.to(torch.float32) / 255.0
    is_building = (label == 1.0).to(torch.float32)
    one_hot = torch.stack([1.0 - is_building, is_building], dim=-1)
    if label_smooth is not None:
        pos, neg = label_smooth
        one_hot = torch.where(one_hot == 1.0, pos, neg)
    f_edge, p_edge = edge_weight_maps(label, cfg.edge_kernel, cfg.edge_iterations, cfg.edge_weight)
    return torch.cat([one_hot, f_edge[..., None], p_edge[..., None]], dim=-1)
