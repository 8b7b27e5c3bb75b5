"""K1 (``quantize_mask_prf_kernel``): its share of its roofline over the
profiled pushes, in % (``metrics_lib.k1_roofline``)."""
from bench.metrics_lib import k1_roofline


def read(ctx):
    return k1_roofline(ctx)
