"""Meshes: the aggregation tier's leaf axis and the model-parallel meshes
(port of ``repro.launch.mesh``).

The JAX tier shards its ``(num_leaves, leaf_buffer, D)`` buffer over a 1-D
``"leaf"`` device mesh and combines leaf partials with a ``psum``.  Here a
:class:`LeafMesh` is the list of devices on that axis, and optionally the
``torch.distributed`` process group whose ranks ARE the axis positions:

- without a group, one process hosts every position (the tier loops over
  its logical leaves on one device);
- with a group of ``W`` ranks, rank ``r`` is axis position ``r`` on its
  own device and hosts leaves ``r * L/W .. (r + 1) * L/W - 1``
  (:func:`leaf_range`); the tier combines the ranks' partials with a
  collective (``core.fl.hierarchy``).

The model-parallel meshes (``("data", "model")`` and ``("pod", "data",
"model")``) are :class:`ShapeMesh` values: axis names and sizes, which is
all the sharding rules of ``launch.sharding`` read.  They carry a
``torch.distributed`` device mesh only when a process group of that many
ranks exists (:func:`make_mesh_compat`).
"""
from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch import device as _device

LEAF_AXIS = "leaf"


@dataclass(frozen=True)
class LeafMesh:
    """A 1-D mesh over the leaf axis: ``devices[i]`` is axis position i.
    ``group`` is the process group whose rank i is position i (None: this
    process holds every position); ``rank`` is this process's position."""

    devices: Tuple[torch.device, ...]
    group: Any = None
    rank: int = 0

    @property
    def shape(self) -> Dict[str, int]:
        return {LEAF_AXIS: len(self.devices)}

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (LEAF_AXIS,)

    @property
    def device(self) -> torch.device:
        """The device this process works on."""
        return self.devices[self.rank]


def _available(devices: Optional[Sequence], device) -> list:
    if devices is not None:
        return [torch.device(d) for d in devices]
    return [_device.resolve(device)]


def _group_mesh(group, device) -> LeafMesh:
    import torch.distributed as tdist

    from repro_torch.launch.dist import rank_device
    dev = _device.resolve(device)
    n = tdist.get_world_size(group)
    return LeafMesh(tuple(rank_device(r, dev) for r in range(n)), group,
                    tdist.get_rank(group))


def make_agg_mesh(num_leaves: int, devices: Optional[Sequence] = None, *,
                  device=None, group=None) -> LeafMesh:
    """A leaf axis with one position per leaf.

    With ``group`` the positions are its ranks, each on
    ``launch.dist.rank_device(rank, device)``, and the group must have
    ``num_leaves`` ranks.  Otherwise ``devices`` pins the list; by default
    the axis is the one device that ``device`` resolves to (the GPU unless
    told otherwise), so only a one-leaf axis fits — more leaves than
    devices need :func:`make_leaf_mesh`, as in the JAX package.
    """
    if group is not None:
        mesh = _group_mesh(group, device)
        if len(mesh.devices) != num_leaves:
            raise ValueError(
                f"aggregation tier wants {num_leaves} leaves, one per rank, "
                f"but the group has {len(mesh.devices)} ranks (use "
                f"make_leaf_mesh to give each rank several leaves)")
        return mesh
    avail = _available(devices, device)
    if num_leaves > len(avail):
        raise ValueError(
            f"aggregation tier wants {num_leaves} leaves but only "
            f"{len(avail)} devices are given (use make_leaf_mesh to "
            f"multiplex logical leaves onto fewer devices)")
    return LeafMesh(tuple(avail[:num_leaves]))


def make_leaf_mesh(num_leaves: int, devices: Optional[Sequence] = None, *,
                   device=None, group=None) -> LeafMesh:
    """A leaf axis for ``num_leaves`` LOGICAL leaves, multiplexing them when
    there are fewer positions than leaves.

    With ``group`` every rank is a position and hosts ``num_leaves / W``
    consecutive leaves; ``W`` must divide ``num_leaves`` (each rank runs
    the same program, so none can sit out).  Without one: the largest
    divisor of ``num_leaves`` that fits the devices, warned when that
    leaves devices unused (a leaf count that divides badly)."""
    if group is not None:
        mesh = _group_mesh(group, device)
        leaves_per_device(num_leaves, mesh)  # validates divisibility
        return mesh
    avail = _available(devices, device)
    n = min(num_leaves, len(avail))
    while num_leaves % n:
        n -= 1
    if n < min(num_leaves, len(avail)):
        warnings.warn(
            f"{num_leaves} logical leaves only divide onto {n} of the "
            f"{len(avail)} available devices (largest divisor); pick a "
            f"leaf count that is a multiple of the device count to use "
            f"the whole mesh", stacklevel=2)
    return make_agg_mesh(n, avail[:n])


def axis_size(mesh, name: str) -> int:
    return mesh.shape.get(name, 1)


def leaves_per_device(num_leaves: int, mesh: LeafMesh) -> int:
    """How many logical leaves each device on the leaf axis hosts."""
    n = axis_size(mesh, LEAF_AXIS)
    if num_leaves % n:
        raise ValueError(
            f"{num_leaves} logical leaves do not divide evenly over the "
            f"{n}-device leaf mesh axis (use make_leaf_mesh)")
    return num_leaves // n


def leaf_range(num_leaves: int, mesh: Optional[LeafMesh]) -> range:
    """The logical leaves this process hosts: its rank's contiguous block
    under a process group, every leaf otherwise."""
    if mesh is None or mesh.group is None:
        return range(num_leaves)
    lpd = leaves_per_device(num_leaves, mesh)
    return range(mesh.rank * lpd, (mesh.rank + 1) * lpd)


# ---------------------------------------------------------------------------
# model-parallel meshes
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeMesh:
    """A mesh by its axis names and sizes (what the sharding rules read);
    ``device_mesh`` is the ``torch.distributed`` ``DeviceMesh`` over the
    same axes when a process group of ``size`` ranks backs it, else None."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    device_mesh: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_mesh_compat(shape, axes) -> ShapeMesh:
    """A ``ShapeMesh`` of ``shape`` over ``axes``; it carries a
    ``DeviceMesh`` when ``torch.distributed`` is initialised with exactly
    that many ranks, of the type of the device this rank works on
    (``launch.dist.current_device``)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not match axes {axes}")
    mesh = ShapeMesh(axes, shape)
    import torch.distributed as tdist
    if (tdist.is_available() and tdist.is_initialized()
            and tdist.get_world_size() == mesh.size):
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.launch.dist import current_device
        mesh = ShapeMesh(axes, shape, init_device_mesh(
            current_device().type, shape, mesh_dim_names=axes))
    return mesh


def make_production_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    """The reference's production layout: a 16 x 16 ``("data", "model")``
    pod, or 2 x 16 x 16 ``("pod", "data", "model")`` across two pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_compat(shape, axes)


def make_host_mesh(data: int = 2, model: int = 2) -> ShapeMesh:
    """A small ``("data", "model")`` mesh for integration tests."""
    return make_mesh_compat((data, model), ("data", "model"))


def batch_axes(mesh) -> Tuple[str, ...]:
    """The axes a client/batch dimension shards over."""
    return ("pod", "data") if "pod" in mesh.shape else ("data",)
