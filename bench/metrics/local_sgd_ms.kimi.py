"""Local SGD: the ``round.local_sgd`` spans' ms per round in the window
(every client's forward and backward pass, remat's recomputation, and
step).  Layer: ``core/fl/round.py`` -> ``models/``.
"""
from bench.metrics_lm_ref import per_round


def read(ctx):
    return per_round(ctx, "round.local_sgd")
