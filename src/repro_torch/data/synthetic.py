"""Synthetic federated datasets: non-IID clients, imbalanced labels, tokens.

Two workload families:
  1. Dense-feature binary classification (the paper's actual workload):
     per-device feature vectors with heterogeneous scales (normalization
     matters), long-tailed label imbalance (balancing matters), ~1 sample
     per device.
  2. Token streams for the LLM architectures: per-client sequences from a
     client-specific Markov generator (Dirichlet label/topic skew) so that
     federated rounds see genuinely non-IID shards.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class ClassifierTask:
    """Ground-truth generator for the binary-classifier experiments."""

    num_features: int = 32
    pos_ratio: float = 0.05  # long-tailed, per the paper's motivation
    feature_scales: Optional[np.ndarray] = None  # heterogeneous raw scales
    seed: int = 0

    def _gen(self):
        rs = np.random.RandomState(self.seed)
        w = rs.normal(size=self.num_features)
        scales = self.feature_scales
        if scales is None:
            # wildly different units: some features O(1), some O(1e3)
            scales = np.exp(rs.uniform(0.0, 7.0, size=self.num_features))
        return rs, w, scales

    def sample_devices(self, n: int, rng_seed: int) -> Dict[str, np.ndarray]:
        """One sample per device (the paper's regime).

        Returns raw (un-normalized) features + labels with class imbalance.
        Label depends on the *normalized* signal, so training on raw features
        without FA normalization converges poorly (paper Fig. 4).
        """
        _, w, scales = self._gen()
        rs = np.random.RandomState(rng_seed)
        z = rs.normal(size=(n, self.num_features))  # the "true" signal
        margin = z @ w / np.sqrt(self.num_features)
        # imbalance: threshold at the (1 - pos_ratio) quantile
        thr = np.quantile(margin, 1.0 - self.pos_ratio)
        y = (margin > thr).astype(np.float32)
        x_raw = z * scales  # what devices actually observe
        return {"features_raw": x_raw.astype(np.float32), "label": y,
                "margin": margin.astype(np.float32)}

    def normalization_oracle(self) -> Tuple[np.ndarray, np.ndarray]:
        """True (mean, std) of raw features — for testing FA estimates."""
        _, _, scales = self._gen()
        return np.zeros(self.num_features), scales


def dirichlet_client_tokens(n_clients: int, samples_per_client: int,
                            seq_len: int, vocab_size: int, *, alpha: float = 0.3,
                            n_topics: int = 8, seed: int = 0) -> np.ndarray:
    """Non-IID token streams: each client mixes topics ~ Dirichlet(alpha).

    Topic t is a distinct bigram process over a vocab slice, so clients have
    measurably different distributions (label/topic skew a la FedML bench).
    Returns tokens (n_clients, samples_per_client, seq_len) int32.
    """
    rs = np.random.RandomState(seed)
    topic_mix = rs.dirichlet([alpha] * n_topics, size=n_clients)
    slice_size = vocab_size // n_topics
    out = np.zeros((n_clients, samples_per_client, seq_len), np.int32)
    for c in range(n_clients):
        for s in range(samples_per_client):
            topic = rs.choice(n_topics, p=topic_mix[c])
            lo = topic * slice_size
            # order-1 Markov walk inside the topic's vocab slice
            tok = rs.randint(lo, lo + slice_size)
            seq = np.empty(seq_len, np.int32)
            for i in range(seq_len):
                seq[i] = tok
                if rs.uniform() < 0.8:  # sticky bigram
                    tok = lo + (tok - lo + rs.randint(1, 4)) % slice_size
                else:
                    tok = rs.randint(lo, lo + slice_size)
            out[c, s] = seq
    return out


def fl_token_batch(n_clients: int, seq_len: int, vocab_size: int,
                   seed: int = 0, samples_per_client: int = 1) -> Dict[str, np.ndarray]:
    """Round batch for LLM FL: next-token prediction per client."""
    toks = dirichlet_client_tokens(n_clients, samples_per_client, seq_len + 1,
                                   vocab_size, seed=seed)
    return {
        "tokens": toks[:, :, :-1].astype(np.int32),
        "labels": toks[:, :, 1:].astype(np.int32),
        "loss_mask": np.ones((n_clients, samples_per_client, seq_len), np.float32),
    }
