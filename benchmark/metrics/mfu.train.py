"""``mfu.train``: the step's counted forward and backward operations over the window, against 989 TFLOP/s.

The configuration's ``flops.train_per_image``
(:func:`benchmark.harness.flops.train_flops`) times the images stepped in the
window, over the window's seconds."""
from benchmark.harness.readers import peak_percent


def read(ctx):
    return peak_percent(ctx, "images", ctx["cell"]["config"].get("flops", {}).get("train_per_image"))
