"""The NoPE latent attentions' forward passes: the fenced ``mla`` spans' ms
per round in the window (the query, latent and up-projections, the
chunked causal softmax core with the shared key part unrotated, the
output), every MLA layer and client.  Layer: ``models/mla.py``.
"""
from bench.metrics_lm_ref import per_round


def read(ctx):
    return per_round(ctx, "mla")
