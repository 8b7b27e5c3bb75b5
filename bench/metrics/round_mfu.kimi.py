"""The whole round's share of the chip's peak, in %: the least time of the
window's rounds (``work/kimi_linear.py`` ``round_work``: the model's
products with KDA's recurrence and the held experts' pairs as counted,
the deltas, sums and parameters moved once, the Threefry-20 draws) at the
published peaks, over the window's time."""
from bench.metrics_lm_ref import round_mfu


def read(ctx):
    return round_mfu(ctx)
