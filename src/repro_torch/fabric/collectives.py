"""The mesh collectives of the fused fabric program, over a leading chip axis.

The JAX package runs a mesh of chips as one ``shard_map`` program over a
``(data, model)`` device mesh, and combines the chips' partial sums with
``jax.lax.psum_scatter`` / ``all_gather`` / ``psum`` / ``pmax``. In the port
every chip of the mesh runs on one torch device: a value that each chip
holds is one tensor whose two leading dims index the chip, ``(data,
model, *block)``, and each collective here is an explicit reduction or
concatenation over those dims. The result is again ``(data, model,
*block')``: what every chip holds after the collective, as the chip's own
function would see it.

Sums run in chip order (``0 .. n-1`` along the axis, data-major over both
axes), the order of ``fabric.shard``'s chip loop, so the fused program
equals the per-layer loop.

Every call adds one to each open :func:`census` under the name of the JAX
primitive it stands for (``psum_scatter`` is ``reduce_scatter``), so a fused
forward's census compares with the JAX program's jaxpr count
(``FabricProgram.collective_counts``).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, Sequence, Union

import torch

__all__ = ["COLLECTIVES", "AXES", "census", "psum_scatter", "all_gather", "psum", "pmax"]

#: The collective primitives a census counts (the JAX package's names).
COLLECTIVES = ("all_gather", "reduce_scatter", "psum", "pmax", "ppermute", "all_to_all")
#: The mesh axes, in the order of a chip-stacked tensor's leading dims.
AXES = ("data", "model")

_CENSUSES: contextvars.ContextVar[tuple] = contextvars.ContextVar("fabric_collective_censuses", default=())


@contextlib.contextmanager
def census() -> Iterator[dict]:
    """Count the collectives called inside the block (nesting composes).

    Example::

        >>> with census() as counts:
        ...     _ = pmax(torch.ones(2, 2), ("data", "model"))
        >>> counts["pmax"], counts["all_gather"]
        (1, 0)
    """
    counts = {name: 0 for name in COLLECTIVES}
    token = _CENSUSES.set(_CENSUSES.get() + (counts,))
    try:
        yield counts
    finally:
        _CENSUSES.reset(token)


def _count(name: str) -> None:
    for counts in _CENSUSES.get():
        counts[name] += 1


def _dims(axes: Union[str, Sequence[str]]) -> tuple:
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(sorted(AXES.index(a) for a in names))


def _sum_in_chip_order(t: torch.Tensor, dims: tuple) -> torch.Tensor:
    """Sum over the chip ``dims`` one chip at a time, in chip order
    (data-major over both axes); the summed dims are kept with size 1."""
    if dims == (0, 1):
        chips = t.reshape(-1, *t.shape[2:]).unbind(0)
    else:
        chips = t.unbind(dims[0])
    total = chips[0]
    for chip in chips[1:]:
        total = total + chip
    return total.reshape(*(1 if i in dims else t.shape[i] for i in range(2)), *t.shape[2:])


def psum_scatter(t: torch.Tensor, axis: str = "model", scatter_dimension: int = 0) -> torch.Tensor:
    """``jax.lax.psum_scatter(x, axis, scatter_dimension=..., tiled=True)``:
    the sum over ``axis`` in chip order, of which chip ``c`` keeps the
    ``c``-th of ``n`` equal pieces along its block's ``scatter_dimension``.

    Example::

        >>> t = torch.arange(8.0).reshape(1, 2, 1, 4)  # two chips of one row
        >>> psum_scatter(t, "model", scatter_dimension=1).tolist()
        [[[[4.0, 6.0]], [[8.0, 10.0]]]]
    """
    _count("reduce_scatter")
    (a,) = _dims(axis)
    n = t.shape[a]
    total = _sum_in_chip_order(t, (a,))
    if total.shape[2 + scatter_dimension] % n:
        raise ValueError(
            f"psum_scatter: block dim {scatter_dimension} ({total.shape[2 + scatter_dimension]}) "
            f"does not split over the {axis} axis ({n})"
        )
    return torch.cat(total.chunk(n, dim=2 + scatter_dimension), dim=a)


def all_gather(t: torch.Tensor, axis: str = "model", gather_dimension: int = 0) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis, axis=gather_dimension, tiled=True)``:
    every chip along ``axis`` gets the chips' blocks concatenated in chip
    order along ``gather_dimension``.

    Example::

        >>> t = torch.arange(4.0).reshape(1, 2, 1, 2)
        >>> all_gather(t, "model", gather_dimension=1).tolist()
        [[[[0.0, 1.0, 2.0, 3.0]], [[0.0, 1.0, 2.0, 3.0]]]]
    """
    _count("all_gather")
    (a,) = _dims(axis)
    n = t.shape[a]
    full = torch.cat(t.unbind(a), dim=1 + gather_dimension).unsqueeze(a)
    return full.expand(*(n if i == a else -1 for i in range(full.dim())))


def psum(t: torch.Tensor, axes: Union[str, Sequence[str]]) -> torch.Tensor:
    """``jax.lax.psum(x, axes)``: every chip gets the sum over ``axes``, in
    chip order.

    Example::

        >>> psum(torch.tensor([[1, 2], [3, 4]]), ("data", "model")).tolist()
        [[10, 10], [10, 10]]
    """
    _count("psum")
    return _sum_in_chip_order(t, _dims(axes)).expand(t.shape)


def pmax(t: torch.Tensor, axes: Union[str, Sequence[str]]) -> torch.Tensor:
    """``jax.lax.pmax(x, axes)``: every chip gets the max over ``axes``.

    Example::

        >>> pmax(torch.tensor([[1.0, 5.0], [3.0, 4.0]]), "model").tolist()
        [[5.0, 5.0], [4.0, 4.0]]
    """
    _count("pmax")
    return torch.amax(t, dim=_dims(axes), keepdim=True).expand(t.shape)
