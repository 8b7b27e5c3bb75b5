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


def _walk(node, prefix: Path, paths: List[Path], leaves: List[Any]) -> None:
    if isinstance(node, dict):
        for k in sorted(node):
            _walk(node[k], prefix + (k,), paths, leaves)
    else:
        paths.append(prefix)
        leaves.append(node)


def flatten(tree) -> Tuple[List[Path], List[Any]]:
    """(paths, leaves) in sorted-key depth-first order.

    The walk is a module-level function: a recursive closure would form a
    reference cycle holding the leaves list, so every flattened tensor
    would outlive its last use until Python's cycle collector ran."""
    paths: List[Path] = []
    leaves: List[Any] = []
    _walk(tree, (), paths, leaves)
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
