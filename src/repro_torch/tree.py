"""Nested-dict parameter trees, flattened in JAX's order.

The JAX package stores models as nested dicts and flattens them with
``jax.tree.flatten``, which visits dict keys in SORTED order.  Chunk offsets
and the positions of every counter-based stream depend on that order, so
the port flattens the same way (``torch.utils._pytree`` keeps insertion
order and would shift them).  Only dicts are tree nodes; everything else
(tensors, ``torch.Size``) is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

Path = Tuple[str, ...]


def flatten(tree) -> Tuple[List[Path], List[Any]]:
    """(paths, leaves) in sorted-key depth-first order."""
    paths: List[Path] = []
    leaves: List[Any] = []

    def walk(node, prefix: Path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + (k,))
        else:
            paths.append(prefix)
            leaves.append(node)

    walk(tree, ())
    return paths, leaves


def leaves(tree) -> List[Any]:
    return flatten(tree)[1]


def unflatten(paths, values) -> Any:
    """Inverse of :func:`flatten` (a single leaf at the empty path)."""
    paths, values = list(paths), list(values)
    if len(paths) == 1 and paths[0] == ():
        return values[0]
    out: dict = {}
    for path, v in zip(paths, values):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` (and the same-structured ``rest``)."""
    paths, xs = flatten(tree)
    others = []
    for r in rest:
        rp, rl = flatten(r)
        if rp != paths:
            raise ValueError(f"tree structures differ: {rp} vs {paths}")
        others.append(rl)
    return unflatten(paths, [fn(*args) for args in zip(xs, *others)])
