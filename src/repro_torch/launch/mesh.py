"""Meshes of the port (counterpart of ``repro.launch.mesh``): the production
meshes of the dry-run planner and the ``(data, model)`` chip mesh of the
multi-chip CiM fabric.

In the port every chip of a mesh runs on one torch device, so a mesh is its
shape only: the planning paths (``launch.shardings.spec_for``'s
divisibility checks, the traffic models) read ``shape`` and ``axis_names``,
and ``fabric.shard`` runs the chips one after another on the device. A mesh
of any size plans and executes, 16 chips included, with no device count to
check.
"""

from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict

__all__ = ["Mesh", "make_production_mesh", "make_local_mesh", "make_chip_mesh"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A shape-only mesh of named axes, ``axes`` = ``((name, size), ...)`` in
    axis order, the ``pod`` axis included where the mesh has one.

    Example::

        >>> mesh = Mesh((("pod", 2), ("data", 16), ("model", 16)))
        >>> mesh.axis_names, mesh.size
        (('pod', 'data', 'model'), 512)
    """

    axes: tuple

    @property
    def axis_names(self) -> tuple:
        return tuple(name for name, _ in self.axes)

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(self.axes)

    @property
    def size(self) -> int:
        return math.prod(size for _, size in self.axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: (16, 16) = (data, model) = 256 chips.
    Multi-pod: (2, 16, 16) = (pod, data, model) = 512 chips."""
    if multi_pod:
        return Mesh((("pod", 2), ("data", 16), ("model", 16)))
    return Mesh((("data", 16), ("model", 16)))


def make_local_mesh() -> Mesh:
    """Degenerate 1x1 mesh: one device."""
    return Mesh((("data", 1), ("model", 1)))


def make_chip_mesh(data: int = 1, model: int = 1) -> Mesh:
    """``(data, model)`` mesh for the multi-chip CiM fabric (``fabric.shard``).

    The JAX package needs ``data * model`` jax devices for an executable
    mesh (its ``require_concrete``); the port runs every chip on one device,
    so it has no such argument.

    Example::

        >>> mesh = make_chip_mesh(data=4, model=4)
        >>> dict(mesh.shape)
        {'data': 4, 'model': 4}
    """
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data}, model={model}")
    return Mesh((("data", data), ("model", model)))
