"""Epoch callbacks for :meth:`Trainer.fit` and :meth:`Trainer.fit_arrays`.

The counterpart of ``building_detection_tpu/train/callbacks.py``.
:class:`EpochVisualizer` runs the trainer's torch model; :class:`EarlyStopping`
holds no model and is a copy of the JAX package's.  A callback is
``cb(trainer, epoch, metrics) -> bool``; True stops training.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from building_detection_tpu_torch.ops import tiling as T
from building_detection_tpu_torch.utils import io as uio


class EpochVisualizer:
    """The reference's ``Display`` callback: after each epoch, predict one
    validation image and write input | label | prediction side by side as
    ``epoch_{N}_display.png`` in ``out_dir``."""

    def __init__(self, image_u8: np.ndarray, label_u8: np.ndarray, out_dir: str):
        """``image_u8`` (H, W, 3), ``label_u8`` (H, W) in {0, 255}."""
        self.image = image_u8
        self.label = label_u8
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)

    def __call__(self, trainer, epoch: int, metrics: Dict[str, float]) -> bool:
        x = T.normalize(torch.from_numpy(self.image[None]).to(trainer.device), dtype=trainer.compute_dtype)
        trainer.model.eval()
        with torch.no_grad():
            probs = trainer.model(x).float()
        pred = (probs[0].argmax(-1).cpu().numpy() * 255).astype(np.uint8)
        h, w = self.label.shape
        canvas = np.zeros((h, w * 3 + 16, 3), np.uint8)
        canvas[:, :w] = self.image
        canvas[:, w + 8 : 2 * w + 8] = self.label[..., None]
        canvas[:, 2 * w + 16 :] = pred[..., None]
        uio.imwrite(os.path.join(self.out_dir, f"epoch_{epoch + 1}_display.png"), canvas)
        return False


class EarlyStopping:
    """Stop when ``monitor`` has not improved for ``patience`` epochs (the
    reference intended this on val_PA but left it commented out,
    `res34.py:610-623`)."""

    def __init__(self, monitor: str = "val_PA", patience: int = 12, mode: str = "max"):
        self.monitor = monitor
        self.patience = patience
        self.mode = mode
        self.best: Optional[float] = None
        self.bad_epochs = 0
        self.stopped_epoch: Optional[int] = None

    def __call__(self, trainer, epoch: int, metrics: Dict[str, float]) -> bool:
        value = metrics.get(self.monitor)
        if value is None:
            return False
        improved = (
            self.best is None
            or (self.mode == "max" and value >= self.best)
            or (self.mode == "min" and value <= self.best)
        )
        if improved:
            self.best = value
            self.bad_epochs = 0
            return False
        self.bad_epochs += 1
        if self.bad_epochs >= self.patience:
            self.stopped_epoch = epoch + 1
            print(f"Epoch {self.stopped_epoch}: early stopping ({self.monitor})")
            return True
        return False
