"""Round uniforms: the ``round.uniforms`` spans' ms per round in the window
(the torch Threefry-20 stochastic-rounding draws of every client leaf).
Layer: ``core/fl/round.py``.
"""
from bench.metrics_lib import per_round


def read(ctx):
    return per_round(ctx, "round.uniforms")
