"""Host Threefry tile passes a round: the system's counter
``prf_host_tiles`` (each pass one batch of ~150 int64 launches) over the
run's rounds: the Threefry-20 rounding uniforms and the TEE noise."""
from bench.metrics_stages import tiles_per_unit


def read(ctx):
    return tiles_per_unit(ctx, "train")
