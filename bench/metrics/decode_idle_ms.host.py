"""Device-idle ms a version inside the system's ``decode`` spans
(``metrics_stages.idle_ms`` over two profiled sessions: each gap between
device-busy runs, on the spans' clock)."""
from bench.metrics_stages import idle_ms


def read(ctx):
    return idle_ms(ctx, "decode", "versions")
