"""Public wrappers for the port's kernels (port of ``repro.kernels.ops``).

Each function runs the hand-written Hopper kernel on CUDA tensors and its
plain PyTorch version on CPU tensors (the kernel modules dispatch by
device).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bitagg as _bitagg
from repro_torch.kernels import dp_clip as _dp_clip
from repro_torch.kernels import flash_decode as _flash
from repro_torch.kernels import secure_agg as _sa


def dp_clip_reduce(deltas: torch.Tensor, clip_norm: float) -> torch.Tensor:
    """(C, D) client deltas -> (D,) sum of per-client-clipped deltas."""
    return _dp_clip.dp_clip_reduce(deltas, clip_norm)


def client_sq_norms(deltas: torch.Tensor) -> torch.Tensor:
    return _dp_clip.sq_norms(deltas)


def secure_agg_encode(x, mask, uniforms, scale: float, value_range: float):
    return _sa.quantize_mask(x, mask, uniforms, scale, value_range)


def secure_agg_decode(q, scale: float):
    """The Pallas ``dequantize``'s arithmetic: ``q * f32(1.0 / scale)``."""
    return _sa.dequantize(q, _sa.pallas_inverse(scale))


def fa_bit_counts(values, thresholds, uniforms, flip_prob: float):
    return _bitagg.bit_counts(values, thresholds, uniforms, flip_prob)


def flash_decode_attention(q, k, v, slot_pos, pos: int, window: int = 0):
    return _flash.flash_decode(q, k, v, slot_pos, pos, window=window)
