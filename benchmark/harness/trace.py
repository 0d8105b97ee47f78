"""A traced stretch of work and what the device did in it.

:func:`record` runs a stretch of work under ``torch.profiler``, and
:func:`reduce` reads the raw events.  With the host's activity recorded
(``host=True``) the stretch runs inside a ``benchmark.window`` span of the
benchmark's own; recording every ATen op and runtime call slows the host
by several microseconds an op, which idles a card that a launch-bound step
keeps busy (res34's bf16 step: 58 % idle traced so, about 25 % from CUDA
events), so the device's share is read from a stretch that records the
card's activity alone (``host=False``), and the host's from a short one.

* the window: the span's start and end on the profiler's clock; without
  host events, the first device event's start to the last one's end (the
  stretch starts after a synchronisation and ends on a fetch);
* device activity: every kernel, copy and memset that ran in the window
  (the device's events, less the device side of host annotations, which
  carry the names of host events), merged into busy intervals, whose total
  is ``busy_s``;
* ``ops``: seconds and launches by device operation name;
* ``gaps``: the idle stretches between busy intervals, each named by the
  innermost host event (an ATen op or a CUDA runtime call) running at its
  middle, or ``host outside any op``, summed by name.
"""
from __future__ import annotations

import bisect
import contextlib
from typing import Dict, List, Tuple

WINDOW = "benchmark.window"
NAME_CHARS = 160


@contextlib.contextmanager
def record(holder: Dict, host: bool):
    """Profile the body (the card's activity, and the host's if ``host``);
    ``holder['events']`` gets the raw events."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    activities = ([ProfilerActivity.CUDA] if cuda else []) + ([ProfilerActivity.CPU] if host or not cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            yield
    holder["events"] = prof.profiler.kineto_results.events()


def _span_ns(e) -> Tuple[int, int]:
    """(start, end) in ns; older torch gives microseconds only."""
    if hasattr(e, "start_ns"):
        return e.start_ns(), e.start_ns() + e.duration_ns()
    return int(e.start_us() * 1000), int((e.start_us() + e.duration_us()) * 1000)


def reduce(events) -> Dict:
    on_device, host = [], []
    for e in events:
        start, end = _span_ns(e)
        (on_device if str(e.device_type()).endswith("CUDA") else host).append((start, end, e.name()))
    window = [(s, e) for s, e, name in host if name == WINDOW]
    if window:
        w0, w1 = window[0]
    elif on_device:
        w0, w1 = min(s for s, _, _ in on_device), max(e for _, e, _ in on_device)
    else:
        raise RuntimeError(f"no {WINDOW!r} span and no device event in the trace")
    host = [h for h in host if h[2] != WINDOW]
    host_names = {name for _, _, name in host} | {WINDOW}
    device: List[Tuple[int, int, str]] = []
    for start, end, name in on_device:
        start, end = max(start, w0), min(end, w1)
        if end > start and name not in host_names:
            device.append((start, end, name))
    ops: Dict[str, List[float]] = {}
    for start, end, name in device:
        slot = ops.setdefault(name, [0.0, 0])
        slot[0] += (end - start) * 1e-9
        slot[1] += 1
    busy, gaps = 0, []
    cursor = w0
    for start, end, _ in sorted(device):
        if start > cursor:
            gaps.append((cursor, start))
        if end > cursor:
            busy += end - max(start, cursor)
            cursor = end
    if w1 > cursor:
        gaps.append((cursor, w1))
    host.sort()
    starts = [h[0] for h in host]
    named: Dict[str, float] = {}
    for g0, g1 in gaps:
        mid, label = (g0 + g1) // 2, "host outside any op"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 4000, -1), -1):  # the latest-starting host event that spans the middle
            if host[j][1] >= mid:
                label = host[j][2]
                break
        named[label] = named.get(label, 0.0) + (g1 - g0) * 1e-9
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": busy * 1e-9,
        "ops": {name: {"seconds": s, "count": n} for name, (s, n) in ops.items()},
        "gaps": named,
    }


def breakdown(summary: Dict, top: int = 10) -> Dict:
    ops = sorted(summary["ops"].items(), key=lambda kv: -kv[1]["seconds"])[:top]
    gaps = sorted(summary["gaps"].items(), key=lambda kv: -kv[1])[:top]
    return {
        "device_ops": [[name[:NAME_CHARS], v["seconds"]] for name, v in ops],
        "idle_gaps": [[name[:NAME_CHARS], s] for name, s in gaps],
    }
