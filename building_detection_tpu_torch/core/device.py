"""The device rule of the port's entry points."""
from __future__ import annotations

import torch


def check_device(device: torch.device) -> None:
    """Raise where ``device`` is a CUDA device that torch cannot see (no
    card at all, or ``cuda:N`` with ``N`` not below the cards visible): the
    port's entry points run on the card unless asked for the CPU, and never
    fall back."""
    if device.type != "cuda":
        return
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but torch sees no CUDA card (pass device='cpu' for the CPU)")
    count = torch.cuda.device_count()
    if device.index is not None and device.index >= count:
        raise RuntimeError(
            f"device {device} asked for, but torch sees {count} CUDA card(s), cuda:0 to cuda:{count - 1} "
            "(nothing falls back to another device)"
        )
