"""The Mamba-2 mixers' forward passes: the fenced ``ssm`` spans' ms per
round in the window (projections, conv, the chunked SSD scan, the gated
norm), every layer and client.  Layer: ``models/ssm.py``.
"""
from bench.metrics_lm_ref import per_round


def read(ctx):
    return per_round(ctx, "ssm")
