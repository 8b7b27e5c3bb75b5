"""Host Threefry tile passes a version: the system's counter
``prf_host_tiles`` (each pass one batch of ~150 int64 launches) over the
run's versions; on the card, the recovery sweep's pair streams."""
from bench.metrics_stages import tiles_per_unit


def read(ctx):
    return tiles_per_unit(ctx, "agg")
