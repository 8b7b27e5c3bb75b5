"""The share of the routed (token, slot) pairs that fall on the experts
held here, in %: the system's ``moe_pairs{held=1}`` over all of
``moe_pairs`` (8/256 = 3.125% under uniform routing).  Layer:
``models/moe.py``.
"""
from bench.metrics_lm_ref import held_share


def read(ctx):
    return held_share(ctx)
