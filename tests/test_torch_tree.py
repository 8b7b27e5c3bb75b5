"""``repro_torch.tree``: JAX's flatten order, and no reference cycle.

A recursive closure in ``flatten`` once formed a cycle holding the flattened
leaves, so every tensor a flatten touched outlived its last use until
Python's cycle collector ran: on the card, the tier's phase of
``chip_smoke.py`` kept earlier servers' 10 GB buffers alive and ran out of
memory.  The guard disables the collector and checks that a flattened
tensor is freed as soon as its last reference goes.
"""
import gc
import weakref

import jax
import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()


def _tree():
    rs = np.random.RandomState(0)
    return {"b": {"z": rs.randn(2).astype(np.float32),
                  "a": rs.randn(3, 2).astype(np.float32)},
            "a": rs.randn(4).astype(np.float32),
            "c": {"y": {"x": rs.randn(1).astype(np.float32)}}}


def test_flatten_order_equals_jax_tree_flatten():
    tree = _tree()
    paths, leaves = T.flatten(tree)
    jleaves = jax.tree.leaves(tree)
    assert paths == [("a",), ("b", "a"), ("b", "z"), ("c", "y", "x")]
    assert all(np.array_equal(a, b) for a, b in zip(leaves, jleaves))
    assert T.unflatten(paths, leaves).keys() == tree.keys()
    doubled = T.tree_map(lambda x, y: x + y, tree, tree)
    assert np.array_equal(doubled["b"]["a"], 2 * tree["b"]["a"])


def test_flatten_leaves_no_reference_cycle():
    gc.collect()
    was = gc.isenabled()
    gc.disable()
    try:
        x = torch.zeros(1000)
        ref = weakref.ref(x)
        T.flatten({"w": {"v": x}, "u": torch.ones(3)})
        T.tree_map(lambda t: t * 2, {"w": x})
        del x
        assert ref() is None, "a flattened tensor outlived its references"
    finally:
        if was:
            gc.enable()
