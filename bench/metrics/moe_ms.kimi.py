"""The MoE FFNs' forward passes: the fenced ``moe`` spans' ms per round in
the window (the sigmoid router over 256 outputs, the 8 held experts'
pairs, the shared expert), every MoE layer and client.  Layer:
``models/moe.py``.
"""
from bench.metrics_lm_ref import per_round


def read(ctx):
    return per_round(ctx, "moe")
