"""The whole aggregation's share of the chip's peak, in %
(``metrics_lib.agg_mfu``): every push and the flush of the window's
versions at the published peaks, over the window's time."""
from bench.metrics_lib import agg_mfu


def read(ctx):
    return agg_mfu(ctx)
