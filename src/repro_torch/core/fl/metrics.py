"""DP model-metric calculation on a held-out evaluation cohort (port of
``repro.core.fl.metrics``).

Devices compute sufficient statistics (confusion counts, score
histograms); only noised aggregates leave the trusted boundary, and the
server derives precision/recall/accuracy/ROC-AUC and the score-skew
diagnostic from them.  The count noise is ``jax.random.normal`` rebuilt by
``kernels.prf.normal`` (the reference's draw, bit for bit).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import prf


def local_eval_stats(logit: torch.Tensor, label: torch.Tensor,
                     n_bins: int = 32,
                     threshold: float = 0.0) -> Dict[str, torch.Tensor]:
    """Per-device sufficient statistics: counts only, no raw scores."""
    score = torch.sigmoid(logit)
    pred = (logit > threshold).to(torch.int32)
    y = label.to(torch.int32)
    f32 = torch.float32
    stats = {
        "tp": torch.sum((pred == 1) & (y == 1)).to(f32),
        "fp": torch.sum((pred == 1) & (y == 0)).to(f32),
        "fn": torch.sum((pred == 0) & (y == 1)).to(f32),
        "tn": torch.sum((pred == 0) & (y == 0)).to(f32),
        "n": torch.tensor(float(logit.numel()), dtype=f32,
                          device=logit.device),
    }
    bins = torch.clamp((score * n_bins).to(torch.int32), 0, n_bins - 1)
    bins = bins.reshape(-1).long()
    zeros = torch.zeros((n_bins,), dtype=f32, device=logit.device)
    stats["hist"] = zeros.index_add(0, bins, torch.ones_like(bins, dtype=f32))
    stats["hist_pos"] = zeros.index_add(0, bins, y.reshape(-1).to(f32))
    return stats


def aggregate_stats(per_device: Dict[str, torch.Tensor], rng,
                    noise_multiplier: float = 1.0,
                    max_samples_per_device: float = 1.0
                    ) -> Dict[str, torch.Tensor]:
    """Sum per-device stats (leading device axis) + Gaussian count noise;
    key ``i`` of ``split(rng)`` noises the ``i``-th stat in sorted order."""
    agg = {k: v.sum(0) for k, v in per_device.items()}
    std = noise_multiplier * max_samples_per_device
    keys = prf.split(rng, len(agg))
    return {k: v + std * prf.normal(kk, tuple(v.shape), device=v.device)
            for (k, v), kk in zip(sorted(agg.items()), keys)}


def derive_metrics(agg: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Server-side consumption: precision/recall/accuracy/AUC + skew."""
    tp, fp, fn, tn = agg["tp"], agg["fp"], agg["fn"], agg["tn"]
    eps = 1e-9
    out = {
        "precision": tp / torch.clamp(tp + fp, min=eps),
        "recall": tp / torch.clamp(tp + fn, min=eps),
        "accuracy": (tp + tn) / torch.clamp(tp + fp + fn + tn, min=eps),
    }
    hist = torch.clamp(agg["hist"], min=0.0)
    hist_pos = torch.minimum(torch.clamp(agg["hist_pos"], min=0.0), hist)
    hist_neg = hist - hist_pos
    # sweep thresholds from high to low score
    tpr = torch.cumsum(hist_pos.flip(0), 0) / torch.clamp(hist_pos.sum(),
                                                          min=eps)
    fpr = torch.cumsum(hist_neg.flip(0), 0) / torch.clamp(hist_neg.sum(),
                                                          min=eps)
    out["roc_auc"] = torch.trapezoid(tpr, fpr)
    out["score_skew"] = score_distribution_skew(hist)
    return out


def score_distribution_skew(hist: torch.Tensor) -> torch.Tensor:
    """Mass piled at the extreme score bins (the paper's Fig. 3)."""
    h = torch.clamp(hist, min=0.0)
    p = h / torch.clamp(h.sum(), min=1e-9)
    edge = hist.shape[0] // 8
    return p[:edge].sum() + p[-edge:].sum()
