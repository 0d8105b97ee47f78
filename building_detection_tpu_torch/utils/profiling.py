"""Named wall-clock stages, the program's spans and counters, and a device
trace: the port's ``utils/profiling.py``.

* :class:`StageTimer`, the counterpart of the JAX package's, used by the
  pipeline to attribute time to the ensemble forward, fusion and polygons;
* :data:`REGISTRY`, the spans and counters that the fused predictor
  (``fused.*``) and the trainer (``train.*``) record at their layer
  boundaries while recording is on;
* :func:`device_trace`, a context manager around ``torch.profiler`` that
  writes a trace TensorBoard or ``chrome://tracing`` loads, and the
  registry's summary beside it.

Recording is on while a ``torch.profiler`` run is active, inside
:func:`device_trace` and inside :func:`recording`; otherwise every site
costs one test of two flags and records nothing.  While it is on:

* a host span (:func:`span`) records its name, start, end, parent span and
  the id its root span (one predictor call, one train step) drew, on the
  profiler's clock (Unix nanoseconds: ``perf_counter_ns`` plus an offset
  taken when recording starts and at every root span); under an active
  profiler it also enters ``record_function(name)``, so the span is in the
  trace and names the idle gaps inside it.  A profiler that records the
  card alone keeps no host event, and no annotation of the span reaches
  its device events;
* a device span (:func:`device_span`, or :func:`span` given a CUDA device)
  is a pair of timing events on a stream.  It is resolved where the
  program already waits for the card (:func:`resolve`), or when the
  summary is read, which waits for its end event; nothing else waits;
* a counter (:func:`count`) adds to a named total;
* each span name keeps its count, its total seconds and a ring of its
  :data:`RING` most recent durations, whose medians the benchmark's
  readers take.

The JAX original's ``sync``/``jax_leaf`` are not copied: a stage
that must include the card's queued work ends in a host fetch or
``torch.cuda.synchronize`` inside its body, as the pipeline's
``ensemble_forward`` stage does by fetching the masks.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import socket
import statistics
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

RING = 1024      # recent durations kept a span name
SPAN_LOG = 4096  # recent host spans kept whole (name, start, end, parent, id)


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


class Series:
    """The durations of one span name: ``count``, total ``seconds`` and the
    ``recent`` ring."""

    __slots__ = ("count", "seconds", "recent")

    def __init__(self):
        self.count, self.seconds, self.recent = 0, 0.0, deque(maxlen=RING)

    def add(self, seconds: float) -> None:
        self.count += 1
        self.seconds += seconds
        self.recent.append(seconds)

    def median(self) -> float:
        return statistics.median(self.recent)


class Registry:
    """Spans and counters in memory; :data:`REGISTRY` is the process's."""

    def __init__(self):
        self.depth = 0  # open recording() contexts
        self._lock = threading.RLock()
        self._local = threading.local()
        self.clear()

    def clear(self) -> None:
        with self._lock:
            self.counters: Dict[str, int] = {}
            self.host: Dict[str, Series] = {}
            self.device: Dict[str, Series] = {}
            self.spans: deque = deque(maxlen=SPAN_LOG)
            self._pending: List[tuple] = []
            self._ids = itertools.count(1)
            self.offset_ns = time.time_ns() - time.perf_counter_ns()

    def empty(self) -> bool:
        return not (self.counters or self.host or self.device or self._pending)

    def stack(self) -> list:
        """This thread's open host spans, innermost last."""
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def add_host(self, name: str, start: int, end: int, parent: Optional[str], span_id: int) -> None:
        with self._lock:
            self.host.setdefault(name, Series()).add((end - start) * 1e-9)
            self.spans.append((name, start + self.offset_ns, end + self.offset_ns, parent, span_id))

    def add_count(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def queue(self, name: str, start, end) -> None:
        with self._lock:
            self._pending.append((name, start, end))

    def resolve(self, wait: bool = False) -> None:
        """Device spans whose end event has run join their series (with
        ``wait``, every queued one, waiting for each end event)."""
        if not self._pending:
            return
        with self._lock:
            keep = []
            for name, start, end in self._pending:
                if wait:
                    end.synchronize()
                elif not end.query():
                    keep.append((name, start, end))
                    continue
                self.device.setdefault(name, Series()).add(start.elapsed_time(end) * 1e-3)
            self._pending = keep

    def median(self, kind: str, name: str) -> Optional[float]:
        """The median of the ring of ``name``'s ``kind`` (``host`` or
        ``device``) spans in seconds; ``None`` if it has none."""
        self.resolve(wait=True)
        series = getattr(self, kind).get(name)
        return series.median() if series and series.recent else None

    def summary(self) -> Dict:
        """Everything recorded, the device spans resolved first: counters;
        per span name its count, total and median seconds; and the recent
        host spans with their start and end on the profiler's clock."""
        self.resolve(wait=True)
        with self._lock:
            def table(d):
                return {k: {"count": s.count, "seconds": s.seconds, "median_s": s.median()} for k, s in d.items()}

            return {
                "clock": "Unix ns, as torch.profiler's events",
                "counters": dict(self.counters),
                "host": table(self.host),
                "device": table(self.device),
                "spans": [dict(zip(("name", "start_ns", "end_ns", "parent", "id"), s)) for s in self.spans],
            }


REGISTRY = Registry()


def on() -> bool:
    """Is recording on (an active profiler, :func:`device_trace` or
    :func:`recording`)?"""
    return REGISTRY.depth > 0 or _autograd_profiler._is_profiler_enabled


class _DeviceSpan:
    __slots__ = ("name", "stream", "start")

    def __init__(self, name: str, stream):
        self.name, self.stream = name, stream

    def __enter__(self):
        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record(self.stream)
        return self

    def __exit__(self, *exc):
        end = torch.cuda.Event(enable_timing=True)
        end.record(self.stream)
        REGISTRY.queue(self.name, self.start, end)
        return False


class _Span:
    """A host span and, on a CUDA ``device``, a device span of its name.
    The trace's range opens first and closes last, so the card's idle time
    while the host does the span's own bookkeeping carries its name."""

    __slots__ = ("name", "root", "device", "dev", "id", "parent", "t0", "rf")

    def __init__(self, name: str, root: bool, device):
        self.name, self.root, self.device = name, root, device

    def __enter__(self):
        self.rf = None
        if _autograd_profiler._is_profiler_enabled:
            self.rf = _autograd_profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        stack = REGISTRY.stack()
        outer = stack[-1] if stack else None
        if self.root or outer is None:
            self.id = next(REGISTRY._ids)
            if self.root:
                REGISTRY.offset_ns = time.time_ns() - time.perf_counter_ns()
        else:
            self.id = outer.id
        self.parent = outer.name if outer is not None else None
        stack.append(self)
        stream = _stream(self.device, None)
        self.dev = _DeviceSpan(self.name, stream).__enter__() if stream is not None else None
        return self

    def __exit__(self, *exc):
        if self.dev is not None:
            self.dev.__exit__()
        stack = REGISTRY.stack()
        if self in stack:  # a span left open by an abandoned iterator sits above it
            del stack[stack.index(self):]
        REGISTRY.add_host(self.name, self.t0, time.perf_counter_ns(), self.parent, self.id)
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        return False


_OFF = contextlib.nullcontext()


def _stream(device, stream):
    if stream is not None:
        return stream
    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.current_stream(device)
    return None


def span(name: str, device=None, root: bool = False):
    """``with span("train.step", device, root=True):`` a host span, and,
    where ``device`` is a CUDA device, a device span of the same name on its
    current stream.  A ``root`` span draws a new id; the others take their
    parent's.  Off: a shared no-op context."""
    if not on():
        return _OFF
    return _Span(name, root, device)


def device_span(name: Optional[str], device=None, stream=None):
    """``with device_span("fused.forward", device):`` the card's time between
    entering and leaving, on ``stream`` (default: ``device``'s current
    stream).  No-op when recording is off, ``name`` is ``None`` or there is
    no CUDA stream."""
    if name is None or not on():
        return _OFF
    stream = _stream(device, stream)
    return _DeviceSpan(name, stream) if stream is not None else _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while recording is on."""
    if on():
        REGISTRY.add_count(name, int(n))


def resolve() -> None:
    """Resolve the device spans whose end has run: call where the program
    has just waited for the card."""
    if REGISTRY._pending:
        REGISTRY.resolve()


@contextlib.contextmanager
def recording():
    """``with recording() as reg:`` records spans and counters without a
    profiler; the outermost entry clears the registry first."""
    with REGISTRY._lock:
        if REGISTRY.depth == 0:
            REGISTRY.clear()
        REGISTRY.depth += 1
    try:
        yield REGISTRY
    finally:
        with REGISTRY._lock:
            REGISTRY.depth -= 1


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """``with device_trace('/tmp/trace') as prof:`` records the CPU activity,
    and the CUDA activity where a card is present, with ``torch.profiler``,
    and on exit writes ``<host>_<pid>.<ms>.pt.trace.json`` under ``log_dir``
    (the name ``tensorboard_trace_handler`` gives), which TensorBoard's
    profiler plugin and ``chrome://tracing`` load, and, where the program
    recorded spans or counters inside, :meth:`Registry.summary` beside it
    as ``<host>_<pid>.<ms>.spans.json``.  ``prof`` is the
    ``torch.profiler.profile``, whose ``key_averages()`` hold the kernel
    rows.  A ``None`` or empty ``log_dir`` makes it a no-op that yields
    ``None``."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    def write(prof):
        os.makedirs(log_dir, exist_ok=True)
        stem = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}.{time.time_ns() // 1_000_000}")
        prof.export_chrome_trace(stem + ".pt.trace.json")
        if not REGISTRY.empty():
            with open(stem + ".spans.json", "w") as f:
                json.dump(REGISTRY.summary(), f, indent=1)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with recording(), profile(activities=activities, on_trace_ready=write) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the trace holds the work enqueued inside it
