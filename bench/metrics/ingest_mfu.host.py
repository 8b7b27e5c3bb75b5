"""The whole push's share of the chip's peak, in %
(``metrics_lib.ingest_mfu``): the push's necessary work at the published
peaks over the mean ingest time."""
from bench.metrics_lib import ingest_mfu


def read(ctx):
    return ingest_mfu(ctx)
