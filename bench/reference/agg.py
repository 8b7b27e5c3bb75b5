"""Plain reference of the buffered asynchronous aggregation (FedBuff with a
secure-aggregation field).

What a published version holds: each contribution ``x`` clipped to
``clip_norm`` by its whole-model L2 norm, weighted by its staleness
``(1 + s)^-a``, the weighted mean over the version's contributions, and
FedAvg's server step ``params + lr * mean``.  The masks cancel and the
field's stochastic rounding is unbiased, so the reference leaves both out:
what it computes is what the protocol promises to deliver.

Departures from a literal version-by-version loop, exact in real
arithmetic: in f32 the change since version 0 is one weighted sum over the
pool of distinct deltas, whose coefficients (the sum over versions of each
contribution's ``w * clip / sum(w)``) are added in f64 on the host.
"""
from __future__ import annotations

import torch


def staleness_weight(s: int, exponent: float) -> float:
    """``(1 + s)^-a`` in f32."""
    return float(torch.pow(torch.tensor(1.0 + s, dtype=torch.float32),
                           -exponent))


def clip_scale(norm: float, clip_norm: float) -> float:
    """``min(1, clip_norm / norm)`` in f32."""
    n = torch.tensor(max(norm, 1e-12), dtype=torch.float32)
    return float(torch.clamp(torch.tensor(clip_norm, dtype=torch.float32) / n,
                             max=1.0))


def pool_norms(pool) -> list:
    """Whole-model f32 L2 norm of each pooled delta (a list of leaves)."""
    out = []
    for leaves in pool:
        sq = sum(float(torch.sum(x.float() * x.float(), dtype=torch.float64))
                 for x in leaves)
        out.append(float(torch.tensor(sq ** 0.5, dtype=torch.float32)))
    return out


def version_coefficients(log, norms, clip_norm: float, exponent: float):
    """Per version, ``[(pool index, w * clip / sum(w))]``: ``log`` lists
    each published version's contributions as ``(pool index, staleness)``."""
    out = []
    for contribs in log:
        w = [staleness_weight(s, exponent) for _, s in contribs]
        total = sum(w)
        out.append([(p, wi * clip_scale(norms[p], clip_norm) / total)
                    for (p, _), wi in zip(contribs, w)])
    return out


def published_change(pool, log, *, clip_norm: float, exponent: float,
                     server_lr: float = 1.0):
    """Per leaf, f32, the parameters' change from version 0 to the last
    version in ``log``."""
    coef = [0.0] * len(pool)
    for version in version_coefficients(log, pool_norms(pool), clip_norm,
                                        exponent):
        for p, c in version:
            coef[p] += c
    out = []
    for i in range(len(pool[0])):
        acc = torch.zeros_like(pool[0][i], dtype=torch.float32)
        for p, c in enumerate(coef):
            if c:
                acc.add_(pool[p][i].float(), alpha=server_lr * c)
        out.append(acc)
    return out


def published_params_lowp(params0, pool, log, *, clip_norm: float,
                          exponent: float, server_lr: float = 1.0,
                          dtype=torch.bfloat16):
    """The reference computed in ``dtype`` and run as the system would,
    version by version: parameters held and updated in ``dtype``, each
    version's weighted mean summed in ``dtype``.  Returns the final
    parameters per leaf (the control of ``correct``)."""
    norms = pool_norms(pool)
    params = [x.to(dtype) for x in params0]
    for version in version_coefficients(log, norms, clip_norm, exponent):
        for i in range(len(params)):
            mean = torch.zeros_like(params[i])
            for p, c in version:
                mean += pool[p][i].to(dtype) * torch.tensor(c, dtype=dtype)
            params[i] += mean * torch.tensor(server_lr, dtype=dtype)
    return params
