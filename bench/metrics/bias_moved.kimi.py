"""The selection bias's reach, in %: the (token, slot) pairs whose expert
is not among the token's unbiased top-8 (``moe_bias_moved``) over all
routed pairs (``moe_pairs``).  Layer: ``models/moe.py``.
"""
from bench.metrics_lm_ref import bias_moved


def read(ctx):
    return bias_moved(ctx)
