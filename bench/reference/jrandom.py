"""``jax.random``'s key derivation and normal draw in plain PyTorch.

The system draws its TEE noise as JAX does (the threefry PRNG), so the
reference, which must add the same noise, derives the same keys and draws:
Threefry-2x32 with 20 rounds (Salmon et al., SC 2011), ``fold_in`` and
``split`` as JAX defines them, the uniform on ``(nextafter(-1, 0), 1)`` and
``sqrt(2) * erfinv(u)``.  Departure: ``erfinv`` is torch's, evaluated in f64
and rounded once to f32, where JAX has its own f32 polynomial, so a draw
may differ from JAX's in its last bit.
"""
from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA
_LO = -0.99999994039535522461  # f32 nextafter(-1, 0)
TILE = 1 << 24


def threefry2x32(k0, k1, x0, x1, rounds: int = 20):
    """Threefry-2x32 on 32-bit words in Python ints or int64 tensors."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(rounds):
        x0 = (x0 + x1) & M32
        r = _ROT[i % 8]
        x1 = (((x1 << r) & M32) | (x1 >> (32 - r))) ^ x0
        if (i + 1) % 4 == 0:
            j = (i + 1) // 4
            x0 = (x0 + ks[j % 3]) & M32
            x1 = (x1 + ks[(j + 1) % 3] + j) & M32
    return x0, x1


def fold_in(key, data: int):
    return threefry2x32(key[0], key[1], 0, int(data) & M32)


def split(key, num: int):
    return [threefry2x32(key[0], key[1], 0, i) for i in range(num)]


def normal(key, shape, device) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` (f32)."""
    n = math.prod(shape)
    out = torch.empty((n,), dtype=torch.float32, device=device)
    k0, k1 = key
    for s in range(0, n, TILE):
        i = torch.arange(s, min(n, s + TILE), dtype=torch.int64,
                         device=device)
        y0, y1 = threefry2x32(k0, k1, i >> 32, i & M32)
        unit = ((y0 ^ y1) >> 9).to(torch.float32) * 2.0 ** -23
        lo = torch.tensor(_LO, dtype=torch.float32, device=device)
        u = torch.maximum(unit * (1.0 - lo) + lo, lo)
        out[s:s + i.numel()] = (math.sqrt(2.0)
                                * torch.erfinv(u.double())).float()
    return out.reshape(shape)
