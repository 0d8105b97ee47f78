"""``dispatch_fill.masks``: the share of the fused predictor's tile slots that carried a tile.

The program's counters over the traced stretches: ``fused.tiles`` (tiles
forwarded) over ``fused.tile_slots`` (``batch_tiles`` a chunk).  A count,
not a time: 1024^2 scenes of 9 tiles go 3 a dispatch (27 of 32 slots) and a
list of 16 ends in a dispatch of one scene; 512^2 scenes fill 32 of 32."""
from benchmark.harness import spans


def read(ctx):
    reg = spans.registry(ctx)
    if reg is None:
        return None
    slots = reg.counters.get("fused.tile_slots", 0)
    return 100.0 * reg.counters.get("fused.tiles", 0) / slots if slots else None
