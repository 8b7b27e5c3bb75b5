"""The row store a push: the system's fenced ``push.store`` spans (the
int32 rows and the slot's weight, norm and clip flag written into the
session buffer) per push of the window, in ms."""
from bench.metrics_stages import stage_ms_per_push


def read(ctx):
    return stage_ms_per_push(ctx, "push.store")
