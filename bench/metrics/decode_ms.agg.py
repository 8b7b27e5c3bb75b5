"""Decode: the mean of the system's fenced ``decode`` spans in the window,
in ms (``metrics_lib.decode_ms``): the int32 sum of the buffer's rows, the
recovery sweep where slots are absent, the decode and the server step."""
from bench.metrics_lib import decode_ms


def read(ctx):
    return decode_ms(ctx)
