"""``edge_roofline.train``: the edge bands of ``make_targets`` against the least time their bytes need.

The least time of one call over the mix's ``(batch, tile, tile)`` labels is
the f32 label read once and two f32 maps written once at 3.35 TB/s
(:func:`benchmark.harness.flops.edge_bytes`: 25.2 MB, 7.5 us at batch 8 and
512^2); it is divided by the mean device time of the program's edge-band
kernel launches (names containing ``edge_weight``) in the traced stretch."""
from benchmark.harness import flops


def read(ctx):
    t = ctx.get("trace")
    if not t:
        return None
    runs = [v for name, v in t["ops"].items() if "edge_weight" in name]
    count, seconds = sum(v["count"] for v in runs), sum(v["seconds"] for v in runs)
    if not count or seconds <= 0:
        return None
    mix = ctx["cell"]["traffic"]
    least = flops.edge_bytes(int(mix["batch"]), int(mix["tile_px"]), int(mix["tile_px"])) / flops.PEAK_HBM_BYTES_PER_S
    return 100.0 * least / (seconds / count)
