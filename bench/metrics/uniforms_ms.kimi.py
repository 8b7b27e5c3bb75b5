"""Round uniforms: the ``round.uniforms`` spans' ms per round in the window
(the Threefry-20 stochastic-rounding draws of every client leaf, 2.82 G
elements a client).  Layer: ``core/fl/round.py``.
"""
from bench.metrics_lm_ref import per_round


def read(ctx):
    return per_round(ctx, "round.uniforms")
