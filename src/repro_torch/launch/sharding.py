"""Layout descriptors of the aggregation tier's state (port of the tier's
part of ``repro.launch.sharding``).

The JAX package returns ``PartitionSpec``/``NamedSharding`` objects; the
port returns the same layout as plain descriptors over a
:class:`~repro_torch.launch.mesh.LeafMesh`: which axes of a tensor are laid
over the leaf axis, and on which device each logical leaf's rows live.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np

from repro_torch.launch.mesh import LEAF_AXIS, LeafMesh, leaves_per_device


class LeafSharding(NamedTuple):
    """A tensor's layout over a leaf mesh: ``spec[i]`` names the mesh axis
    dimension ``i`` is split over (``()`` = replicated)."""

    mesh: LeafMesh
    spec: Tuple[str, ...]

    @property
    def device_set(self) -> set:
        return set(self.mesh.devices)


def hierarchy_specs(leaf_axis: str = LEAF_AXIS) -> Dict[str, Tuple[str, ...]]:
    """The tier's layout: the (num_leaves, leaf_buffer, D) contribution
    buffer and every (num_leaves, leaf_buffer) per-slot scalar split their
    LEADING axis over the leaf axis; params, optimizer state and
    session-wide scalars replicate."""
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
    """(num_leaves,) int: the leaf-axis position hosting each LOGICAL leaf;
    consecutive leaves fold onto one device when leaves outnumber devices
    (the identity at one leaf per device)."""
    lpd = leaves_per_device(num_leaves, mesh)  # validates divisibility
    return np.repeat(np.arange(mesh.shape[LEAF_AXIS]), lpd)
