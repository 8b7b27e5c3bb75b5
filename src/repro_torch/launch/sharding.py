"""Sharding rules: where every tensor of a model, a batch, a cache and the
aggregation tier lives on a mesh (port of ``repro.launch.sharding``).

A spec is a tuple with one entry per tensor dimension: ``None``
(replicated), a mesh axis name, or a tuple of axis names — the reference's
``PartitionSpec`` entries, so a port spec equals ``tuple(P(...))``.  The
rules read only the mesh's axis sizes (``mesh.shape``), so specs need no
process group.  :func:`to_shardings` turns specs into per-mesh-axis
``Shard(dim)``/``Replicate()`` placements (the ``torch.distributed``
``DTensor`` layout), with the ``DeviceMesh`` attached when one exists.

Model-parallel scheme (the reference's):
  - tensor parallel (TP) on the ``model`` axis: attention heads, MLP
    hidden, experts (expert parallelism), vocab;
  - optional FSDP on the ``data`` axis: the non-TP matrix dimension;
  - scanned stacks have a leading layer dimension (never sharded);
  - a dimension gets a mesh axis only if its size divides the axis size
    (kv=2 heads on a 16-way model axis stay replicated).

The tier's layout: the ``(num_leaves, leaf_buffer, D)`` buffer and every
``(num_leaves, leaf_buffer)`` per-slot scalar split their leading axis
over the leaf axis; params, optimizer state and session scalars replicate.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.launch.mesh import (LEAF_AXIS, LeafMesh, batch_axes,
                                     leaves_per_device)

Spec = Tuple[Any, ...]


# ---------------------------------------------------------------------------
# model-parallel specs
# ---------------------------------------------------------------------------
def _shape_of(leaf) -> Tuple[int, ...]:
    return tuple(leaf) if isinstance(leaf, torch.Size) else tuple(leaf.shape)


def _fits(dim: int, mesh, axis) -> bool:
    if axis is None:
        return False
    if isinstance(axis, tuple):
        n = math.prod(mesh.shape[a] for a in axis)
    else:
        n = mesh.shape.get(axis, 1)
    return dim % n == 0 and n > 1


def _maybe(dim: int, mesh, axis):
    """``axis`` when ``dim`` splits over it, else None; a one-name tuple as
    the bare name (``PartitionSpec``'s canonical form)."""
    if not _fits(dim, mesh, axis):
        return None
    return axis[0] if isinstance(axis, tuple) and len(axis) == 1 else axis


def _leaf_spec(path, shape, mesh, tp, fsdp) -> Spec:
    """The reference's rule table, keyed by the leaf's parameter name."""
    name = path[-1]
    off = 1 if "scan" in path else 0  # stacked layer dim leads

    def spec(*axes):
        axes = tuple(_maybe(shape[off + i], mesh, a)
                     for i, a in enumerate(axes))
        full = (None,) * off + axes
        # never reuse a mesh axis across dims of one tensor
        seen, out = set(), []
        for a in full:
            names = a if isinstance(a, tuple) else (a,)
            if a is not None and any(n in seen for n in names):
                out.append(None)
            else:
                out.append(a)
                seen.update(n for n in names if n)
        return tuple(out)

    d = len(shape) - off
    if name == "embed":
        return spec(tp, fsdp)
    if name == "unembed":
        return spec(fsdp, tp)
    if name == "pos_embed":
        return spec(None, None)
    if name in ("wq", "wk", "wv"):
        return spec(fsdp, tp, None)
    if name == "wo":
        return spec(tp, None, fsdp)
    if name in ("bq", "bk", "bv"):
        return spec(tp, None)
    if name in ("w_in", "w_gate", "w_branch") and d == 2:
        return spec(fsdp, tp)
    if name == "w_out" and d == 2:
        return spec(tp, fsdp)
    if name in ("w_in", "w_gate") and d == 3:  # stacked experts (E, d, f)
        if _fits(shape[off], mesh, tp):
            return spec(tp, fsdp, None)  # expert parallelism
        return spec(None, fsdp, tp)  # few experts: TP the hidden
    if name == "w_out" and d == 3:  # (E, f, d)
        if _fits(shape[off], mesh, tp):
            return spec(tp, None, fsdp)
        return spec(None, tp, fsdp)
    if name == "router":
        return spec(fsdp, None)
    if name == "in_proj":  # mamba (d, proj)
        return spec(fsdp, tp)
    if name == "out_proj":  # mamba (di, d)
        return spec(tp, fsdp)
    if name in ("w_a", "w_x"):  # rglru gates (r, r)
        return spec(None, tp)
    if name == "conv_w":
        return spec(None, None)
    # 1-D / small leaves (norms, biases, dt_bias, A_log, D, lambda, ...)
    return (None,) * len(shape)


def param_specs(params, mesh, *, tp="model", fsdp_axis=None):
    """Tree of specs mirroring ``params`` (tensors or ``torch.Size``)."""
    paths, leaves = T.flatten(params)
    return T.unflatten(paths, [
        _leaf_spec(p, _shape_of(x), mesh, tp, fsdp_axis)
        for p, x in zip(paths, leaves)])


class Sharding(NamedTuple):
    """One tensor's layout: its spec and, per mesh axis, the ``DTensor``
    placement (``Shard(dim)`` or ``Replicate()``); ``device_mesh`` is the
    mesh's ``DeviceMesh`` or None."""

    spec: Spec
    placements: tuple
    device_mesh: Any = None


def placements_of(spec: Spec, mesh) -> tuple:
    """Per mesh axis (in the mesh's order), ``Shard(d)`` for the tensor
    dimension ``d`` it splits, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    dims: Dict[str, int] = {}
    for d, a in enumerate(spec):
        for n in (a if isinstance(a, tuple) else (a,)):
            if n is not None:
                dims[n] = d
    return tuple(Shard(dims[a]) if a in dims else Replicate()
                 for a in mesh.shape)


def to_shardings(specs, mesh):
    """Tree of :class:`Sharding` for a tree of specs (a spec is a tuple,
    so a leaf of the dict tree)."""
    dm = getattr(mesh, "device_mesh", None)
    paths, leaves = T.flatten(specs)
    return T.unflatten(paths, [Sharding(tuple(s), placements_of(s, mesh), dm)
                               for s in leaves])


def param_shardings(params, mesh, *, tp="model", fsdp_axis=None):
    return to_shardings(param_specs(params, mesh, tp=tp,
                                    fsdp_axis=fsdp_axis), mesh)


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------
def train_batch_specs(batch, mesh, *, client_axis=None, seq_axis=None):
    """Cohort batch: leaves (cohort, local_B, seq...) or (cohort,)."""

    def f(shape):
        dims: List[Any] = [None] * len(shape)
        if len(shape) >= 1:
            dims[0] = _maybe(shape[0], mesh, client_axis)
        if seq_axis is not None and len(shape) >= 3:
            dims[2] = _maybe(shape[2], mesh, seq_axis)
        return tuple(dims)

    paths, leaves = T.flatten(batch)
    return T.unflatten(paths, [f(_shape_of(x)) for x in leaves])


def infer_batch_specs(batch, mesh):
    """Inference batch: the leading dim is the request batch."""
    ba = batch_axes(mesh)

    def f(shape):
        dims: List[Any] = [None] * len(shape)
        if len(shape) >= 1:
            dims[0] = _maybe(shape[0], mesh, ba)
        return tuple(dims)

    paths, leaves = T.flatten(batch)
    return T.unflatten(paths, [f(_shape_of(x)) for x in leaves])


def cache_specs(cache, mesh, *, shard_seq: bool = False):
    """KV/state cache: batch on (pod, data), kv-heads on ``model`` when they
    divide it; ``shard_seq`` shards the cache SEQUENCE dim on ``model``
    instead (the flash-decode layout when kv heads < the model axis)."""
    ba = batch_axes(mesh)

    def f(path, shape):
        name = path[-1]
        off = 1 if "scan" in path else 0
        dims: List[Any] = [None] * len(shape)
        if name == "pos":  # (W,) slot positions, replicated
            return tuple(dims)
        if off < len(shape):
            dims[off] = _maybe(shape[off], mesh, ba)  # batch dim
        if name in ("k", "v", "cross_k", "cross_v") and len(shape) >= off + 4:
            if shard_seq:
                dims[off + 1] = _maybe(shape[off + 1], mesh, "model")
            else:
                dims[off + 2] = _maybe(shape[off + 2], mesh, "model")
        elif name == "ssm" and len(shape) >= off + 4:
            dims[off + 1] = _maybe(shape[off + 1], mesh, "model")  # heads
        elif name == "conv" and len(shape) >= off + 3:
            dims[off + 2] = _maybe(shape[off + 2], mesh, "model")  # channels
        elif name == "h" and len(shape) >= off + 2:
            dims[off + 1] = _maybe(shape[off + 1], mesh, "model")  # width
        return tuple(dims)

    paths, leaves = T.flatten(cache)
    return T.unflatten(paths, [f(p, _shape_of(x))
                               for p, x in zip(paths, leaves)])


# ---------------------------------------------------------------------------
# the aggregation tier
# ---------------------------------------------------------------------------
class LeafSharding(NamedTuple):
    """A tensor's layout over a leaf mesh: ``spec[i]`` names the mesh axis
    dimension ``i`` is split over (``()`` = replicated)."""

    mesh: LeafMesh
    spec: Tuple[str, ...]

    @property
    def device_set(self) -> set:
        return set(self.mesh.devices)

    def blocks(self, num_leaves: int) -> List[Tuple[torch.device, range]]:
        """Per axis position (a rank under a process group): its device and
        the logical leaves whose rows it holds — a contiguous block when
        the leading axis is split, every leaf when replicated."""
        if not self.spec:
            return [(d, range(num_leaves)) for d in self.mesh.devices]
        lpd = leaves_per_device(num_leaves, self.mesh)
        return [(d, range(i * lpd, (i + 1) * lpd))
                for i, d in enumerate(self.mesh.devices)]


def hierarchy_specs(leaf_axis: str = LEAF_AXIS) -> Dict[str, Tuple[str, ...]]:
    """The tier's layout: buffer and per-slot scalars split their LEADING
    axis over the leaf axis; params, optimizer state and session-wide
    scalars replicate."""
    return {
        "buffer": (leaf_axis,),
        "per_slot": (leaf_axis,),
        "replicated": (),
    }


def hierarchy_shardings(mesh: LeafMesh,
                        leaf_axis: str = LEAF_AXIS) -> Dict[str, LeafSharding]:
    """:func:`hierarchy_specs` over ``mesh``."""
    return {k: LeafSharding(mesh, s)
            for k, s in hierarchy_specs(leaf_axis).items()}


def leaf_device_map(num_leaves: int, mesh: LeafMesh) -> np.ndarray:
    """(num_leaves,) int: the leaf-axis position (the rank, under a process
    group) hosting each LOGICAL leaf; consecutive leaves fold onto one
    position when leaves outnumber positions."""
    lpd = leaves_per_device(num_leaves, mesh)  # validates divisibility
    return np.repeat(np.arange(mesh.shape[LEAF_AXIS]), lpd)
