"""Kimi Delta Attention's forward passes: the fenced ``kda`` spans' ms per
round in the window (the projections, short convolutions and norms, the
decay and ``beta``, the chunked delta rule with its loop over the chunks,
the gated output norm and the output), every KDA layer and client.
Layer: ``models/kda.py``.
"""
from bench.metrics_lm_ref import per_round


def read(ctx):
    return per_round(ctx, "kda")
