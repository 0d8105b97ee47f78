"""The device rule of the port's entry points."""
from __future__ import annotations

import torch


def check_device(device: torch.device) -> None:
    """Raise where ``device`` is a CUDA device that torch cannot see: the
    port's entry points run on the card unless asked for the CPU, and never
    fall back."""
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but torch sees no CUDA card (pass device='cpu' for the CPU)")
