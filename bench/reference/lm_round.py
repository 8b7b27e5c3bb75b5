"""One client's local SGD step and the synchronous DP-FL round over any
plain loss ``loss(params, batch) -> scalar``: the round of
``reference/granite.py`` with the model's loss an argument, for the
references of ``entries/train_lm_ref.py``."""
from __future__ import annotations

import math

import torch

from bench.reference import jrandom
from bench.reference.common import flatten, unflatten


def local_delta(loss, params, batch, lr: float):
    """One client's SGD step; returns (delta leaves, its loss)."""
    paths = [q for q, _ in flatten(params)]
    leaves = [x.detach().requires_grad_(True) for _, x in flatten(params)]
    value = loss(unflatten(paths, leaves), batch)
    grads = torch.autograd.grad(value, leaves)
    with torch.no_grad():
        return [-lr * g for g in grads], float(value.detach())


def sync_round(loss, params, batch, round_key, *, cohort: int, lr: float,
               clip_norm: float, noise_multiplier: float, server_lr: float,
               noise_tag: int):
    """One DP-FL round with weights 1 and noise in the TEE, client by
    client: every client's delta clipped by its whole-model norm, the mean,
    Gaussian noise of std ``noise_multiplier * clip_norm / cohort`` drawn as
    the system draws it (``split(fold_in(key, noise_tag), leaves)[i]``),
    FedAvg.  Returns (new params, mean loss, noised mean delta leaves, the
    clean mean delta's leaf norms)."""
    paths = [q for q, _ in flatten(params)]
    p0 = [x for _, x in flatten(params)]
    acc = [torch.zeros_like(x) for x in p0]
    losses = []
    for c in range(cohort):
        cb = {k: v[c] for k, v in batch.items()}
        delta, value = local_delta(loss, params, cb, lr)
        losses.append(value)
        norm = math.sqrt(sum(float(torch.sum(d.double() ** 2))
                             for d in delta))
        scale = min(1.0, clip_norm / max(norm, 1e-12))
        for a, d in zip(acc, delta):
            a.add_(d, alpha=scale)
        del delta
    std = noise_multiplier * clip_norm / cohort
    keys = jrandom.split(jrandom.fold_in(round_key, noise_tag), len(p0))
    clean = []
    for a, k in zip(acc, keys):
        a.div_(cohort)
        clean.append(float(torch.linalg.vector_norm(a.double())))
        if std > 0:
            a.add_(std * jrandom.normal(k, tuple(a.shape), a.device))
    new = [x + server_lr * a for x, a in zip(p0, acc)]
    return unflatten(paths, new), sum(losses) / cohort, acc, clean
