"""Differential privacy primitives: per-client clipping and Gaussian noise.

Port of ``repro.core.fl.dp``.  Clipping is arithmetic and matches the JAX
function up to the order of the float sum in the norm.  ``add_noise`` draws
the reference's own noise: ``jax.random.split`` + ``jax.random.normal``
rebuilt by ``kernels.prf``, bit for bit (the jitted reference contracts
the add into an FMA, so a noised value may differ in its last bit).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import tree as T
from repro_torch.kernels import prf


def global_norm(tree) -> torch.Tensor:
    """L2 norm across every leaf (f32 accumulation, leaf-order left fold)."""
    sq = None
    for x in T.leaves(tree):
        s = torch.sum(torch.square(x.to(torch.float32)))
        sq = s if sq is None else sq + s
    return prf.sqrt_f32(sq)


def clip_update(update, clip_norm: float) -> Tuple:
    """Scale ``update`` so its global L2 norm is <= clip_norm.

    Returns (clipped_update, pre_clip_norm, was_clipped).
    """
    nrm = global_norm(update)
    cn = torch.tensor(clip_norm, dtype=torch.float32, device=nrm.device)
    scale = torch.clamp(cn / torch.clamp(nrm, min=1e-12), max=1.0)
    clipped = T.tree_map(
        lambda x: (x.to(torch.float32) * scale).to(x.dtype), update)
    return clipped, nrm, scale < 1.0


def add_noise(update, key, stddev: float):
    """Add isotropic Gaussian noise with the given std to every leaf: leaf
    ``i`` draws ``normal(split(key, n_leaves)[i], shape)``, as the JAX
    function does."""
    paths, leaves = T.flatten(update)
    out = [x + (stddev * prf.normal(k, x.shape, device=x.device)).to(x.dtype)
           for x, k in zip(leaves, prf.split(key, len(leaves)))]
    return T.unflatten(paths, out)


def noise_stddev(fl_cfg, cohort_size: int, placement: str) -> float:
    """Noise std per the placement semantics (see the JAX module)."""
    if fl_cfg.noise_multiplier <= 0.0:
        return 0.0
    if placement == "tee":
        return fl_cfg.noise_multiplier * fl_cfg.clip_norm / cohort_size
    if placement == "device":
        return fl_cfg.noise_multiplier * fl_cfg.clip_norm
    raise ValueError(placement)
