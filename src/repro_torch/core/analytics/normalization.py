"""Feature normalization from federated-analytics statistics (port of
``repro.core.analytics.normalization``; challenge 6).

Normalization factors are learned globally via the bit protocol over a
random device sample, inside the trusted boundary:
  - zscore: (x - mean) / std        (mean + second-moment bit queries)
  - minmax: (x - p01) / (p99 - p01) (robust percentile scaling from one
    threshold-grid CDF vote, through ``bitagg.threshold_cdf`` and K9)

The resulting ``NormalizationFactors`` go to the (untrusted) metadata
store and are pushed to devices, where the Signal Transformer applies them.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.analytics import bitagg
from repro_torch.kernels import prf


@dataclass(frozen=True)
class NormalizationFactors:
    scheme: str  # zscore | minmax
    shift: np.ndarray  # (n_features,) f32
    scale: np.ndarray  # (n_features,) f32

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return ((x - torch.as_tensor(self.shift, device=x.device))
                / torch.as_tensor(self.scale, device=x.device))


def learn_zscore(feature_sample: torch.Tensor, lo: float, hi: float, rng,
                 flip_prob: float = 0.0) -> NormalizationFactors:
    """feature_sample: (n_devices, n_features) from the FA device cohort.
    Two bit queries per feature (x, then x^2)."""
    k1, k2 = prf.split(rng)
    mean_bits = bitagg.encode_mean_bits(feature_sample, lo, hi, k1, flip_prob)
    hi2 = max(abs(lo), abs(hi)) ** 2
    sq_bits = bitagg.encode_mean_bits(torch.square(feature_sample), 0.0, hi2,
                                      k2, flip_prob)
    mean = bitagg.estimate_mean(mean_bits, lo, hi, flip_prob)
    var = bitagg.estimate_variance(mean_bits=mean_bits, sq_bits=sq_bits,
                                   lo=lo, hi=hi, flip_prob=flip_prob)
    std = prf.sqrt_f32(torch.clamp(var, min=1e-6))
    return NormalizationFactors("zscore", mean.cpu().numpy(),
                                std.cpu().numpy())


def learn_minmax(feature_sample: torch.Tensor, lo: float, hi: float, rng,
                 n_thresholds: int = 64, q_lo: float = 0.01,
                 q_hi: float = 0.99,
                 flip_prob: float = 0.0) -> NormalizationFactors:
    """Robust percentile scaling from one threshold-grid bit query."""
    thresholds = bitagg.linspace(lo, hi, n_thresholds,
                                 device=feature_sample.device)
    cdf = bitagg.threshold_cdf(feature_sample, thresholds, rng, flip_prob)
    p_lo = bitagg.percentile_from_cdf(cdf, thresholds, q_lo)
    p_hi = bitagg.percentile_from_cdf(cdf, thresholds, q_hi)
    scale = torch.clamp(p_hi - p_lo, min=1e-6)
    return NormalizationFactors("minmax", p_lo.cpu().numpy(),
                                scale.cpu().numpy())
