"""Learning-rate schedules as plain functions of the step.

The counterpart of ``building_detection_tpu/train/schedule.py``, computed
in f32 as the JAX version is:

* :func:`warmup_cosine` — per-step linear warmup, then a half-cosine decay
  (the reference's ``cosine_decay_with_warmup``), floored at
  ``min_learn_rate``;
* :func:`exponential_decay` — per-epoch ``lr * decay ** epoch``.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

f32 = np.float32


def warmup_cosine(
    learning_rate_base: float,
    total_steps: int,
    warmup_learning_rate: float = 0.0,
    warmup_steps: int = 0,
    min_learn_rate: float = 0.0,
) -> Callable[[int], float]:
    """``schedule(step) -> lr``."""

    def schedule(step) -> float:
        step = f32(step)
        cosine = f32(0.5) * f32(learning_rate_base) * (
            f32(1) + np.cos(
                f32(np.pi) * (step - f32(warmup_steps))
                / f32(max(total_steps - warmup_steps, 1))
            )
        )
        if warmup_steps > 0:
            k = f32((learning_rate_base - warmup_learning_rate) / warmup_steps)
            linear = k * step + f32(warmup_learning_rate)
        else:
            linear = f32(learning_rate_base)
        lr = cosine if step >= warmup_steps else linear
        return float(max(lr, f32(min_learn_rate)))

    return schedule


def exponential_decay(
    lr_base: float = 1e-3, decay: float = 0.9, min_lr: float = 0.0
) -> Callable[[int], float]:
    """Per-epoch decay; pass the epoch index."""

    def schedule(epoch) -> float:
        return float(max(f32(lr_base) * np.power(f32(decay), f32(epoch)), f32(min_lr)))

    return schedule
