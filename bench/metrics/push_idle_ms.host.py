"""Device-idle ms a push inside the system's ``push`` spans and outside
their nested ``decode`` (``metrics_stages.idle_ms`` over two profiled
sessions: each gap between device-busy runs, on the spans' clock)."""
from bench.metrics_stages import idle_ms


def read(ctx):
    return idle_ms(ctx, "push", "pushes", outside="decode")
