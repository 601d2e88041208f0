"""The ``(data, model)`` chip mesh of the multi-chip CiM fabric (counterpart
of ``repro.launch.mesh.make_chip_mesh``).

In the port every chip of a mesh runs on one torch device, so a mesh is its
shape only: the planning paths (``launch.shardings.spec_for``'s
divisibility checks, the traffic models) read ``shape`` and ``axis_names``,
and ``fabric.shard`` runs the chips one after another on the device. A mesh
of any size plans and executes, 16 chips included, with no device count to
check.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

__all__ = ["ChipMesh", "make_chip_mesh"]


@dataclasses.dataclass(frozen=True)
class ChipMesh:
    """A shape-only ``(data, model)`` mesh: ``shape`` maps each axis name to
    its size, in axis order.

    Example::

        >>> mesh = ChipMesh(2, 4)
        >>> mesh.axis_names, dict(mesh.shape)
        (('data', 'model'), {'data': 2, 'model': 4})
    """

    data: int
    model: int

    axis_names = ("data", "model")

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict((("data", self.data), ("model", self.model)))


def make_chip_mesh(data: int = 1, model: int = 1) -> ChipMesh:
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
    return ChipMesh(data, model)
