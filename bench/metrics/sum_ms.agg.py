"""The flush's integer sum a version: the system's fenced ``decode.sum``
spans (one per chunk: the int64 sum of the buffer's int32 rows, wrapped to
int32) summed per version of the window, in ms."""
from bench.metrics_stages import stage_ms_per_version


def read(ctx):
    return stage_ms_per_version(ctx, "decode.sum")
