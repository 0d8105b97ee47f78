"""Named wall-clock stages and a device trace: the port's ``utils/profiling.py``.

* :class:`StageTimer`, the counterpart of the JAX package's, used by the
  pipeline to attribute time to the ensemble forward, fusion and polygons;
* :func:`device_trace`, a context manager around ``torch.profiler`` that
  writes a trace TensorBoard or ``chrome://tracing`` loads.

The JAX original's ``sync``/``jax_leaf`` are not copied: a stage
that must include the card's queued work ends in a host fetch or
``torch.cuda.synchronize`` inside its body, as the pipeline's
``ensemble_forward`` stage does by fetching the masks.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from typing import Dict, Optional


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


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """``with device_trace('/tmp/trace') as prof:`` records the CPU activity,
    and the CUDA activity where a card is present, with ``torch.profiler``,
    and on exit writes a ``*.pt.trace.json`` under ``log_dir`` that
    TensorBoard's profiler plugin and ``chrome://tracing`` load.  ``prof`` is
    the ``torch.profiler.profile``, whose ``key_averages()`` hold the kernel
    rows.  A ``None`` or empty ``log_dir`` makes it a no-op that yields
    ``None``."""
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the trace holds the work enqueued inside it
