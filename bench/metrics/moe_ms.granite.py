"""The MoE FFNs' forward passes: the fenced ``moe`` spans' ms per round in
the window (router, the held experts' pairs, the shared expert), every
layer and client.  Layer: ``models/moe.py``.
"""
from bench.metrics_lm import per_round


def read(ctx):
    return per_round(ctx, "moe")
