"""``dispatch_overhead.masks``: the share of a dispatch's device time outside the members' forward.

From the program's device spans: one minus the median ``fused.forward``
(a chunk's five member stages and their argmax bits) times the chunks a
dispatch, over the median ``fused.dispatch`` (from the wait for the group's
upload to its fetch copy, on the compute stream).  The rest is the tile
gather, the canvas OR, the bitplane pack, the fetch copy and the card's
waits for the host's launches.  Medians, so the short stretch that records
the host's activity too weighs no more than its share of the dispatches."""
from benchmark.harness import spans


def read(ctx):
    reg = spans.registry(ctx)
    if reg is None:
        return None
    forward, dispatch = reg.median("device", "fused.forward"), reg.median("device", "fused.dispatch")
    chunks, dispatches = reg.counters.get("fused.chunks", 0), reg.counters.get("fused.dispatches", 0)
    if not forward or not dispatch or not chunks or not dispatches:
        return None
    return 100.0 * (1.0 - forward * chunks / dispatches / dispatch)
