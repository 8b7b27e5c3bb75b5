"""Helpers of the plain references: trees of tensors and the comparisons.

The references import nothing of the system under test.  A model is a
nested dict of tensors; its leaves are visited in sorted-key order, the
order the system's own parameter trees use, so leaf ``i`` here is leaf
``i`` there.
"""
from __future__ import annotations

import statistics
from contextlib import contextmanager

import torch


def flatten(tree, prefix=()):
    """[(path, leaf)] of a nested dict, keys sorted at every level."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(flatten(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def unflatten(paths, values) -> dict:
    """The nested dict of :func:`flatten`'s paths and leaves."""
    out: dict = {}
    for path, v in zip(paths, values):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


@contextmanager
def plain_f32(tf32: bool = False):
    """Matrix products in true f32 (TF32 off), or in TF32 for the control."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _floor(ref_norms):
    return statistics.median(ref_norms) if ref_norms else 0.0


def worst_leaf_diff(prog, ref, keep=None) -> float:
    """Largest ``|prog_i - ref_i| / max(|ref_i|, median_j |ref_j|)`` over
    leaves (L2 norms), the leaves ``keep`` selects."""
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    rn = [float(torch.linalg.vector_norm(ref[i].double())) for i in idx]
    floor = _floor(rn)
    worst = 0.0
    for i, r in zip(idx, rn):
        d = float(torch.linalg.vector_norm(
            prog[i].double() - ref[i].double()))
        worst = max(worst, d / max(r, floor, 1e-30))
    return worst


def worst_norm_gap(prog_norms, ref_norms, keep=None) -> float:
    """Largest ``| |prog_i| - |ref_i| | / max(|ref_i|, median_j |ref_j|)``
    over the leaves ``keep`` selects (given their L2 norms)."""
    idx = [i for i in range(len(ref_norms)) if keep is None or keep[i]]
    rn = [ref_norms[i] for i in idx]
    floor = _floor(rn)
    return max((abs(prog_norms[i] - ref_norms[i]) / max(ref_norms[i], floor,
                                                         1e-30)
                for i in idx), default=0.0)
