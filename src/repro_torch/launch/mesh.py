"""The aggregation tier's leaf axis as a plain index map (port of the tier's
part of ``repro.launch.mesh``).

The JAX tier shards its ``(num_leaves, leaf_buffer, D)`` buffer over a 1-D
``"leaf"`` device mesh and combines leaf partials with a ``psum``.  Here a
:class:`LeafMesh` is just the list of devices on that axis; a logical leaf
lives on the axis position ``leaf // leaves_per_device``.  With one GPU the
axis holds that one device, so every logical leaf maps to it: the tier
keeps its leaves as the leading axis of one device-resident buffer.  The
multi-GPU mesh (``torch.distributed``) is not ported yet.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch import device as _device

LEAF_AXIS = "leaf"


@dataclass(frozen=True)
class LeafMesh:
    """A 1-D mesh over the leaf axis: ``devices[i]`` is axis position i."""

    devices: Tuple[torch.device, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return {LEAF_AXIS: len(self.devices)}

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (LEAF_AXIS,)


def _available(devices: Optional[Sequence], device) -> list:
    if devices is not None:
        return [torch.device(d) for d in devices]
    return [_device.resolve(device)]


def make_agg_mesh(num_leaves: int, devices: Optional[Sequence] = None, *,
                  device=None) -> LeafMesh:
    """A leaf axis with one device per leaf (``num_leaves`` positions).

    ``devices`` pins the list; by default the axis is the one device that
    ``device`` resolves to (the GPU unless told otherwise), so only a
    one-leaf axis fits — more leaves than devices need
    :func:`make_leaf_mesh`, as in the JAX package.
    """
    avail = _available(devices, device)
    if num_leaves > len(avail):
        raise ValueError(
            f"aggregation tier wants {num_leaves} leaves but only "
            f"{len(avail)} devices are given (use make_leaf_mesh to "
            f"multiplex logical leaves onto fewer devices)")
    return LeafMesh(tuple(avail[:num_leaves]))


def make_leaf_mesh(num_leaves: int, devices: Optional[Sequence] = None, *,
                   device=None) -> LeafMesh:
    """A leaf axis for ``num_leaves`` LOGICAL leaves, multiplexing them when
    there are fewer devices than leaves: the largest divisor of
    ``num_leaves`` that fits the devices, warned when that leaves devices
    unused (a leaf count that divides badly)."""
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


def axis_size(mesh: LeafMesh, name: str) -> int:
    return mesh.shape.get(name, 1)


def leaves_per_device(num_leaves: int, mesh: LeafMesh) -> int:
    """How many logical leaves each device on the leaf axis hosts."""
    n = axis_size(mesh, LEAF_AXIS)
    if num_leaves % n:
        raise ValueError(
            f"{num_leaves} logical leaves do not divide evenly over the "
            f"{n}-device leaf mesh axis (use make_leaf_mesh)")
    return num_leaves // n
