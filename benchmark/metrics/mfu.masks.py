"""``mfu.masks``: the five members' counted forward operations over the window, against 989 TFLOP/s.

The configuration's ``flops.forward_per_tile`` (one count a member,
:func:`benchmark.harness.flops.forward_flops`) times the planned tiles whose
masks came back in the window, over the window's seconds."""
from benchmark.harness.readers import peak_percent


def read(ctx):
    per_tile = ctx["cell"]["config"].get("flops", {}).get("forward_per_tile")
    return peak_percent(ctx, "tiles", sum(per_tile.values()) if per_tile else None)
