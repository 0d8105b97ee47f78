"""Named wall-clock stages: the port's own ``StageTimer``.

The counterpart of ``building_detection_tpu/utils/profiling.py::StageTimer``,
used by the pipeline to attribute time to the ensemble forward, fusion and
polygons.  The JAX original's ``sync``/``jax_leaf`` are not copied: a stage
that must include the card's queued work ends in a host fetch or
``torch.cuda.synchronize`` inside its body, as the pipeline's
``ensemble_forward`` stage does by fetching the masks.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from typing import Dict


class StageTimer:
    """Accumulating named wall-clock stages.

    >>> t = StageTimer()
    >>> with t.stage("forward"): ...
    >>> t.summary()  # {'forward': {'seconds': ..., 'calls': ...}}
    """

    def __init__(self):
        self._acc: "OrderedDict[str, float]" = OrderedDict()
        self._calls: Dict[str, int] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:  # stages may run on post-processing pool threads
                self._acc[name] = self._acc.get(name, 0.0) + dt
                self._calls[name] = self._calls.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"seconds": round(v, 4), "calls": self._calls[k]}
            for k, v in self._acc.items()
        }

    def report(self) -> str:
        total = sum(self._acc.values()) or 1.0
        lines = [
            f"{k:>16s}: {v:8.3f}s ({100 * v / total:5.1f}%)  x{self._calls[k]}"
            for k, v in self._acc.items()
        ]
        return "\n".join(lines)

    def reset(self) -> None:
        self._acc.clear()
        self._calls.clear()
