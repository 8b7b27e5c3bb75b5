"""The device's idle share over the profiled sessions, in %: 1 minus the
union of kernel, copy and set intervals over the traced window."""
from bench.metrics_lib import idle_share


def read(ctx):
    return idle_share(ctx, "agg")
