"""Bit-efficient federated analytics (port of
``repro.core.analytics.bitagg``; Cormode & Markov 2021, paper ref [4]).

Each device contributes ONE BIT per queried statistic: ``Bernoulli((x -
lo) / (hi - lo))`` for a mean, ``1[x <= t]`` for each threshold ``t`` of a
CDF query.  Local differential privacy is randomized response: with
probability ``flip_prob`` a bit is replaced by a fair coin, and the server
debiases ``E[b_rr] = (1 - p) E[b] + p / 2``.

Every draw is the reference's (``jax.random`` rebuilt by
``kernels.prf``), and the arithmetic is its f32 arithmetic, so bits, means
and CDFs are bit-equal to the JAX module.  Two rules of that arithmetic:
``jnp.mean`` over axis 0 is ``sum * f32(1/N)`` (XLA multiplies by the
reciprocal of a constant divisor), and the threshold grid is
:func:`linspace`, XLA's formula, not ``torch.linspace``.

:func:`threshold_cdf` is the fused CDF vote: it draws the randomized
response uniforms one device tile at a time and sums the votes with K9
(``kernels.bitagg.bit_counts``), never holding the ``(N, F, T)`` bits.  It
is the only route by which the analytics path reaches K9.
"""
from __future__ import annotations

import torch

from repro_torch.core import telemetry as tele
from repro_torch.kernels import bitagg as kbitagg
from repro_torch.kernels import prf

F32 = torch.float32
# f32 elements (devices x features x thresholds) of one device tile of
# threshold_cdf: 2^16 devices of a 32 x 128 query on the card (1.07 GB of
# uniforms); smaller on the CPU, where the plain version holds a few
# temporaries of the tile's size
VOTE_TILE_CUDA = 1 << 28
VOTE_TILE_CPU = 1 << 22


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=F32, device=device)


def mean0(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean(x, 0)`` of f32 ``x``: the sum times ``f32(1) / f32(N)``."""
    n = x.shape[0]
    return x.to(F32).sum(0) * (_f32(1.0, x.device) / _f32(float(n), x.device))


def linspace(lo: float, hi: float, n: int, *, device=None) -> torch.Tensor:
    """``jnp.linspace(lo, hi, n)`` in f32, as XLA's CPU code computes it:
    ``c = f32(1) / f32(n - 1)``, point ``i < n - 1`` is
    ``fma(i, f32(hi * c), f32(lo * f32(1 - f32(i * c))))`` and the last
    point is ``hi``.  Bit-equal at the reference's grids; XLA contracts
    other multiply-adds at some sizes, and there the two differ by an ulp
    of the grid's magnitude."""
    lo_t, hi_t = _f32(lo, "cpu"), _f32(hi, "cpu")
    if n <= 1:
        return lo_t.reshape(1)[:n].to(device)
    one = _f32(1.0, "cpu")
    c = one / _f32(float(n - 1), "cpu")
    i = torch.arange(n - 1, dtype=F32)
    out = prf.fma_f32(i, (hi_t * c).expand_as(i), lo_t * (one - i * c))
    return torch.cat([out, hi_t.reshape(1)]).to(device)


def encode_mean_bits(values: torch.Tensor, lo: float, hi: float, rng,
                     flip_prob: float = 0.0) -> torch.Tensor:
    """values: (n_devices, n_features) -> uint8 bits, one per (device,
    feature): ``Bernoulli((x - lo) / (hi - lo))``, then randomized
    response."""
    dev = values.device
    p = torch.clamp((values - _f32(lo, dev)) / _f32(hi - lo, dev), 0.0, 1.0)
    k1, k2, k3 = prf.split(rng, 3)
    bits = prf.uniform(k1, values.shape, device=dev) < p
    if flip_prob > 0.0:
        flip = prf.uniform(k2, values.shape, device=dev) < _f32(flip_prob,
                                                               dev)
        coin = prf.uniform(k3, values.shape, device=dev) < _f32(0.5, dev)
        bits = torch.where(flip, coin, bits)
    return bits.to(torch.uint8)


def encode_threshold_bits(values: torch.Tensor, thresholds: torch.Tensor,
                          rng, flip_prob: float = 0.0) -> torch.Tensor:
    """values: (n, f); thresholds: (t,) -> bits (n, f, t): ``1[x <= thr]``,
    then randomized response.  Holds all ``n * f * t`` bits; the server's
    CDF vote is :func:`threshold_cdf`."""
    bits = values[..., None] <= thresholds
    if flip_prob > 0.0:
        dev = values.device
        k1, k2 = prf.split(rng)
        flip = prf.uniform(k1, bits.shape, device=dev) < _f32(flip_prob, dev)
        coin = prf.uniform(k2, bits.shape, device=dev) < _f32(0.5, dev)
        bits = torch.where(flip, coin, bits)
    return bits.to(torch.uint8)


def debias(bit_mean: torch.Tensor, flip_prob: float) -> torch.Tensor:
    """Invert randomized response on an aggregated bit mean."""
    if flip_prob <= 0.0:
        return bit_mean
    dev = bit_mean.device
    return torch.clamp((bit_mean - _f32(flip_prob / 2.0, dev))
                       / _f32(1.0 - flip_prob, dev), 0.0, 1.0)


def estimate_mean(bits: torch.Tensor, lo: float, hi: float,
                  flip_prob: float = 0.0) -> torch.Tensor:
    """bits: (n_devices, n_features) -> unbiased mean estimate per
    feature."""
    m = debias(mean0(bits), flip_prob)
    return _f32(lo, m.device) + m * _f32(hi - lo, m.device)


def estimate_cdf(bits: torch.Tensor, flip_prob: float = 0.0) -> torch.Tensor:
    """bits: (n, f, t) threshold bits -> monotone CDF estimate (f, t)."""
    cdf = debias(mean0(bits), flip_prob)
    # enforce monotonicity (isotonic projection via running max)
    return torch.cummax(cdf, dim=-1).values


def _vote_tile_rows(F: int, T: int, device) -> int:
    tile = VOTE_TILE_CUDA if device.type == "cuda" else VOTE_TILE_CPU
    return max(1, tile // max(1, F * T))


def _rr_uniforms(k1, k2, start: int, stop: int, flip_prob: float,
                 device) -> torch.Tensor:
    """K9's uniforms at flat vote counters ``[start, stop)``: ``u1`` where
    the bit is kept, 0 (a forced 1) or ``f32(p / 2)`` (a forced 0) where
    ``u1 < p`` flips it to the coin ``u2 < 0.5``."""
    half, p = kbitagg.rr_thresholds(flip_prob, device)
    zero, coin = _f32(0.0, device), _f32(0.5, device)
    out = torch.empty((stop - start,), dtype=F32, device=device)
    step = prf.jax_tile(device)
    for s in range(start, stop, step):
        t = min(stop, s + step)
        u1 = prf.uniform_span(k1, s, t, device=device)
        u2 = prf.uniform_span(k2, s, t, device=device)
        out[s - start:t - start] = torch.where(
            u1 < p, torch.where(u2 < coin, zero, half), u1)
    return out


def threshold_cdf(values: torch.Tensor, thresholds: torch.Tensor, rng,
                  flip_prob: float = 0.0) -> torch.Tensor:
    """The fused CDF vote: exactly ``estimate_cdf(encode_threshold_bits(
    values, thresholds, rng, flip_prob), flip_prob)``, (f, t).

    Devices are voted in tiles: rows ``[n0, n1)`` are the counters
    ``[n0 F T, n1 F T)`` of the reference's ``uniform(k1/k2, (N, F, T))``
    draws, folded into K9's single uniform (:func:`_rr_uniforms`; nothing
    is drawn at ``flip_prob == 0``, as in the reference).  Each tile is
    one K9 launch; the tiles' counts are integers below 2^24, added in f32
    exactly.  This is the only route by which the analytics path reaches
    K9 (``kernels.bitagg.bit_counts``).

    Spans (fenced when the registry fences): ``fa.vote`` around the whole
    vote, and per tile ``fa.vote.draws`` (the torch Threefry-20 uniforms)
    and ``fa.vote.bit_counts`` (K9)."""
    N, F = values.shape
    T = thresholds.shape[0]
    dev = values.device
    tel = tele.get_default()
    thr = thresholds.to(F32).contiguous()
    vals = values.to(F32)
    rows = _vote_tile_rows(F, T, dev)
    counts = torch.zeros((F, T), dtype=F32, device=dev)
    if flip_prob > 0.0:
        k1, k2 = prf.split(rng)
    else:
        zeros = torch.zeros((min(rows, N), F, T), dtype=F32, device=dev)
    with tel.span("fa.vote", devices=N, tiles=-(-N // rows)) as vote:
        for n0 in range(0, N, rows):
            n1 = min(N, n0 + rows)
            with tel.span("fa.vote.draws") as sp:
                if flip_prob > 0.0:
                    u = _rr_uniforms(k1, k2, n0 * F * T, n1 * F * T,
                                     flip_prob, dev).reshape(n1 - n0, F, T)
                else:
                    u = zeros[:n1 - n0]
                sp.fence(u)
            with tel.span("fa.vote.bit_counts") as sp:
                part = kbitagg.bit_counts(vals[n0:n1].contiguous(), thr, u,
                                          flip_prob)
                sp.fence(part)
            counts += part
            del u
        mean = counts * (_f32(1.0, dev) / _f32(float(N), dev))
        cdf = torch.cummax(debias(mean, flip_prob), dim=-1).values
        vote.fence(cdf)
    return cdf


def percentile_from_cdf(cdf: torch.Tensor, thresholds: torch.Tensor,
                        q: float) -> torch.Tensor:
    """Linear-interpolated q-quantile (q in [0,1]) from a threshold-grid
    CDF."""
    dev = cdf.device
    t = thresholds.to(F32)
    qt = _f32(q, dev)
    idx = torch.clamp(torch.sum(cdf < qt, dim=-1), 0, len(thresholds) - 1)
    idx0 = torch.clamp(idx - 1, min=0)
    c0 = torch.gather(cdf, -1, idx0[..., None])[..., 0]
    c1 = torch.gather(cdf, -1, idx[..., None])[..., 0]
    t0, t1 = t[idx0], t[idx]
    w = torch.where(c1 > c0, (qt - c0) / torch.clamp(c1 - c0,
                                                     min=_f32(1e-9, dev)),
                    _f32(0.0, dev))
    return t0 + torch.clamp(w, 0.0, 1.0) * (t1 - t0)


def estimate_variance(*, mean_bits: torch.Tensor, sq_bits: torch.Tensor,
                      lo: float = 0.0, hi: float = 1.0,
                      flip_prob: float = 0.0) -> torch.Tensor:
    """Var from two bit queries: E[x] and E[x^2] (x^2 in [0, hi^2])."""
    m = estimate_mean(mean_bits, lo, hi, flip_prob)
    hi2 = max(abs(lo), abs(hi)) ** 2
    m2 = estimate_mean(sq_bits, 0.0, hi2, flip_prob)
    return torch.clamp(m2 - torch.square(m), min=0.0)


# ---------------------------------------------------------------------------
# Interactive bisection (log2(range)/round precision per extra round)
# ---------------------------------------------------------------------------
def bisect_percentile(sample_fn, lo: float, hi: float, q: float,
                      rounds: int, rng, flip_prob: float = 0.0) -> float:
    """Multi-round single-threshold protocol: each round asks a fresh device
    sample for ``1[x <= mid]`` bits (one :func:`threshold_cdf` vote) and
    halves the bracket.

    ``sample_fn(rng) -> (n_devices,)`` tensor of values from a *fresh*
    random device cohort.
    """
    for r in range(rounds):
        mid = 0.5 * (lo + hi)
        k1, k2 = prf.split(prf.fold_in(rng, r))
        vals = sample_fn(k1)
        thr = torch.tensor([mid], dtype=F32, device=vals.device)
        frac = float(threshold_cdf(vals[:, None], thr, k2, flip_prob)[0, 0])
        if frac < q:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)
