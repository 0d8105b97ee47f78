"""``optimizer_share.train``: Keras Adam's share of the train step's device time.

From the program's device spans: the median ``train.optimizer``
(``KerasAdam.step``) over the median ``train.step``.  Medians, so the two
steps of the stretch that records the host's activity too, which the
recording slows, weigh no more than their share."""
from benchmark.harness import spans


def read(ctx):
    reg = spans.registry(ctx)
    if reg is None:
        return None
    optimizer, step = reg.median("device", "train.optimizer"), reg.median("device", "train.step")
    if not optimizer or not step:
        return None
    return 100.0 * optimizer / step
