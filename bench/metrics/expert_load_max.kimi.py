"""The held experts' imbalance: ``moe_held_load_max`` (the largest held
expert's pairs, summed over forward passes) over the mean held load.  1 is
even; the buffers are sized to the largest.  Layer: ``models/moe.py``.
"""
from bench.metrics_lm_ref import load_max


def read(ctx):
    return load_max(ctx)
