"""Arithmetic shared by the per-layer metric readers in ``benchmark/metrics/``.

A reader gets the run's context: ``cell`` (its configuration, mix and
check), ``window`` (``seconds`` and the work ``done``, from the host clock
around the measured window) and ``trace`` (:func:`benchmark.harness.trace.reduce`
of the traced stretch, or ``None``).  It returns a number, or ``None`` where
the run gives it nothing to read; never 0 for a share it could not read.
"""
from __future__ import annotations

from typing import Dict, Optional

from benchmark.harness import flops


def idle_percent(ctx: Dict) -> Optional[float]:
    t = ctx.get("trace")
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def peak_percent(ctx: Dict, work: str, flops_per_unit: Optional[float]) -> Optional[float]:
    """Counted operations over the window against the bf16 dense peak."""
    w = ctx.get("window")
    if not w or not flops_per_unit or not w["done"].get(work):
        return None
    return 100.0 * w["done"][work] * flops_per_unit / w["seconds"] / flops.PEAK_BF16_FLOPS
