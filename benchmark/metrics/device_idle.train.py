"""``device_idle.*``: the share of the traced stretch in which no kernel, copy or memset ran on the card."""
from benchmark.harness.readers import idle_percent


def read(ctx):
    return idle_percent(ctx)
