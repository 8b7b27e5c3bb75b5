"""Ingest: the mean self time of a push in the window, in ms
(``metrics_lib.ingest_ms``): the whole-model clip, the staleness weight,
K1's encode and mask, the row's store.  Layer: ``core/fl/async_fl.py``
``AsyncServer``."""
from bench.metrics_lib import ingest_ms


def read(ctx):
    return ingest_ms(ctx)
