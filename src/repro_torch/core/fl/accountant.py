"""RDP accountant for the subsampled Gaussian mechanism (Mironov 2017/2019).

Tracks the privacy cost of DP-FL rounds: each round is one release of a
clipped, noised cohort aggregate, with Poisson sampling rate
q = cohort / population.  Integer-alpha RDP of the subsampled Gaussian is
computed with the exact binomial expansion; conversion to (eps, delta) uses
the standard bound eps = min_alpha [ rdp(alpha) + log(1/delta)/(alpha-1) ].
Pure-python/numpy — runs on the untrusted server (it sees only counts).
"""
from __future__ import annotations

import math
from typing import Iterable, Sequence

DEFAULT_ALPHAS: Sequence[int] = tuple(range(2, 65)) + (128, 256)


def _log_comb(n: int, k: int) -> float:
    return math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)


def _logsumexp(xs: Iterable[float]) -> float:
    xs = list(xs)
    m = max(xs)
    if m == -math.inf:
        return -math.inf
    return m + math.log(sum(math.exp(x - m) for x in xs))


def rdp_gaussian(sigma: float, alpha: int) -> float:
    """RDP of the (unsampled) Gaussian mechanism, sensitivity 1."""
    return alpha / (2.0 * sigma * sigma)


def rdp_subsampled_gaussian(q: float, sigma: float, alpha: int) -> float:
    """Exact integer-alpha RDP of the Poisson-subsampled Gaussian.

    eps(alpha) = 1/(alpha-1) * log( sum_{k=0}^{alpha} C(alpha,k)
                  (1-q)^(alpha-k) q^k exp(k(k-1)/(2 sigma^2)) )
    """
    if q == 0.0 or sigma <= 0.0:
        return 0.0 if sigma > 0 else math.inf
    if q == 1.0:
        return rdp_gaussian(sigma, alpha)
    terms = []
    for k in range(alpha + 1):
        log_term = (_log_comb(alpha, k)
                    + (alpha - k) * math.log1p(-q)
                    + k * math.log(q)
                    + k * (k - 1) / (2.0 * sigma * sigma))
        terms.append(log_term)
    return _logsumexp(terms) / (alpha - 1)


def compute_epsilon(q: float, sigma: float, rounds: int, delta: float,
                    alphas: Sequence[int] = DEFAULT_ALPHAS) -> float:
    """(eps, delta)-DP after `rounds` subsampled-Gaussian releases."""
    if sigma <= 0.0:
        return math.inf
    best = math.inf
    for a in alphas:
        rdp = rounds * rdp_subsampled_gaussian(q, sigma, a)
        eps = rdp + math.log(1.0 / delta) / (a - 1)
        best = min(best, eps)
    return best


def noise_for_epsilon(q: float, rounds: int, target_eps: float, delta: float,
                      lo: float = 0.3, hi: float = 64.0) -> float:
    """Smallest sigma achieving target_eps (bisection)."""
    for _ in range(64):
        mid = 0.5 * (lo + hi)
        if compute_epsilon(q, mid, rounds, delta) > target_eps:
            lo = mid
        else:
            hi = mid
    return hi


class RDPAccountant:
    """Stateful accountant accumulating per-round RDP across alphas."""

    def __init__(self, alphas: Sequence[int] = DEFAULT_ALPHAS):
        self.alphas = tuple(alphas)
        self._rdp = [0.0] * len(self.alphas)

    def step(self, q: float, sigma: float, num_steps: int = 1) -> None:
        for i, a in enumerate(self.alphas):
            self._rdp[i] += num_steps * rdp_subsampled_gaussian(q, sigma, a)

    def epsilon(self, delta: float) -> float:
        best = math.inf
        for a, r in zip(self.alphas, self._rdp):
            best = min(best, r + math.log(1.0 / delta) / (a - 1))
        return best
