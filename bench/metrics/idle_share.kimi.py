"""The device's idle share over the profiled round, in %: 1 minus the
union of kernel, copy and set intervals over the traced window."""
from bench.metrics_lm_ref import idle_share


def read(ctx):
    return idle_share(ctx)
