"""Label balancing via federated analytics (port of
``repro.core.analytics.label_balance``; challenge 1, paper Fig. 3).

The label is "treated as yet another feature": a bit query over a random
device cohort estimates the positive-class ratio during training; the
estimate goes to the metadata store, and the Orchestrator turns it into a
per-class sample drop-off rate applied at submission time on device.  The
draws are the reference's (``kernels.prf``), so the ratio and every
drop-off mask are bit-equal to the JAX module's.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.analytics import bitagg
from repro_torch.kernels import prf

F32 = torch.float32


@dataclass(frozen=True)
class DropoffPolicy:
    """Per-class keep probabilities enforcing a target label ratio."""

    keep_pos: float
    keep_neg: float
    estimated_pos_ratio: float

    def keep_probability(self, label) -> torch.Tensor:
        label = torch.as_tensor(label, dtype=F32)
        dev = label.device
        return (label * torch.tensor(self.keep_pos, dtype=F32, device=dev)
                + (1.0 - label) * torch.tensor(self.keep_neg, dtype=F32,
                                               device=dev))


def estimate_label_ratio(labels: torch.Tensor, rng,
                         flip_prob: float = 0.0) -> float:
    """labels: (n_devices,) in {0,1} from an FA cohort -> P(y=1) estimate.

    The label bit IS the message; randomized response still protects each
    device's true label.  An (n, 1) mean, which no kernel computes here or
    in the reference.
    """
    dev = labels.device
    bits = labels.to(torch.uint8)[:, None]
    if flip_prob > 0.0:
        k1, k2 = prf.split(rng)
        flip = prf.uniform(k1, bits.shape, device=dev) < torch.tensor(
            flip_prob, dtype=F32, device=dev)
        coin = prf.uniform(k2, bits.shape, device=dev) < torch.tensor(
            0.5, dtype=F32, device=dev)
        bits = torch.where(flip, coin.to(torch.uint8), bits)
    return float(bitagg.debias(bitagg.mean0(bits.reshape(-1)), flip_prob))


def policy_from_ratio(pos_ratio: float,
                      target_pos_ratio: float = 0.5) -> DropoffPolicy:
    """Down-sample the majority class to hit the target ratio in
    expectation: keep_minority = 1, keep_majority so that after drop-off
    P(y=1 | kept) == target."""
    pos_ratio = min(max(pos_ratio, 1e-6), 1.0 - 1e-6)
    t = target_pos_ratio
    # odds needed: keep_pos * p / (keep_neg * (1-p)) == t / (1-t)
    if pos_ratio < t:  # positives are the minority
        keep_pos = 1.0
        keep_neg = (pos_ratio / (1.0 - pos_ratio)) * ((1.0 - t) / t)
    else:
        keep_neg = 1.0
        keep_pos = ((1.0 - pos_ratio) / pos_ratio) * (t / (1.0 - t))
    return DropoffPolicy(min(keep_pos, 1.0), min(keep_neg, 1.0), pos_ratio)


def apply_dropoff(labels: torch.Tensor, policy: DropoffPolicy,
                  rng) -> torch.Tensor:
    """Sample-submission weights (1 keep / 0 drop) for a training cohort:
    ``uniform(rng, labels.shape) < keep_probability(labels)``."""
    keep_p = policy.keep_probability(labels)
    u = prf.uniform(rng, tuple(labels.shape), device=keep_p.device)
    return (u < keep_p).to(F32)
