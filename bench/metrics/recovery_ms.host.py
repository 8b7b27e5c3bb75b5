"""The recovery sweep a version: the system's fenced ``decode.recover``
spans (one per chunk: the absent slot's host Threefry pair streams added to
the sum) summed per version of the window, in ms."""
from bench.metrics_stages import stage_ms_per_version


def read(ctx):
    return stage_ms_per_version(ctx, "decode.recover")
