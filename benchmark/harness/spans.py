"""The program's own spans and counters, for the per-layer readers that read them.

``building_detection_tpu_torch.utils.profiling`` keeps them in memory while
``torch.profiler`` runs, so the traced stretches of a ``--trace 1`` run fill
them; the measured window runs with recording off.  Device spans are CUDA
timing events the program records on its streams, resolved here (each end
event waited for) before they are read.  A run without a trace, a program
without the registry (an older checkout) and a registry that recorded
nothing all give ``None``.
"""
from __future__ import annotations

from typing import Dict


def registry(ctx: Dict):
    """The program's registry with what the traced stretches recorded, or ``None``."""
    if ctx.get("trace") is None:
        return None
    try:
        from building_detection_tpu_torch.utils import profiling
    except ImportError:
        return None
    reg = getattr(profiling, "REGISTRY", None)
    if reg is None or reg.empty():
        return None
    reg.resolve(wait=True)
    return reg

