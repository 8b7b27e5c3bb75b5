"""Device ``jax.random`` draws a round (each one launch of the system's
Threefry-20 draw kernel: a client leaf's rounding uniforms, a leaf of the
TEE noise), by ``prf_device_draws``.  Layer: ``kernels/prf.py``.
"""
from bench.metrics_lm_ref import prf_draws


def read(ctx):
    return prf_draws(ctx)
