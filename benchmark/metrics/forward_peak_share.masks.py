"""``forward_peak_share.masks``: the members' counted forward operations over the forward's own device time, against 989 TFLOP/s.

The configuration's ``flops.forward_per_tile`` summed over the members,
times the program's ``fused.tiles`` counter, over the summed device seconds
of its ``fused.forward`` spans (each chunk's member stages), all over the
traced stretches.  ``mfu.masks`` divides the same operations by the whole
window, so this reads at or above it by the share of the window the card
spends outside the forward."""
from benchmark.harness import flops, spans


def read(ctx):
    reg = spans.registry(ctx)
    per_tile = ctx["cell"]["config"].get("flops", {}).get("forward_per_tile")
    if reg is None or not per_tile:
        return None
    forward, tiles = reg.device.get("fused.forward"), reg.counters.get("fused.tiles", 0)
    if forward is None or forward.seconds <= 0 or not tiles:
        return None
    return 100.0 * sum(per_tile.values()) * tiles / forward.seconds / flops.PEAK_BF16_FLOPS
