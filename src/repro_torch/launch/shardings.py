"""Divisibility-aware sharding rules (the planning half of
``repro.launch.shardings``).

Logical axes:
  * ``tp``   -> mesh axis ("model",)            tensor parallelism
  * ``fsdp`` -> ("data",)                       parameter/optimizer sharding
  * ``dp``   -> ("data",)                       batch sharding

A dim that does not divide its assigned mesh axes falls back to replication
for that dim — every fallback is recorded so a caller sees exactly what got
replicated.

Fallback records are *scoped*, not global: wrap the spec-building calls in
``with record_fallbacks() as fb:`` and read ``fb`` afterwards. Callers that
don't open a recorder get no bookkeeping and leak nothing.

:func:`spec_for` returns a plain tuple, one entry per dim: a mesh axis name,
a tuple of names, or ``None`` (replicated). The parameter, batch and cache
shardings of training and mesh serving are not ported yet (ROADMAP.md, port
queue A10).
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Iterator, Optional, Sequence

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

__all__ = ["logical_to_mesh", "spec_for", "axes_size", "record_fallbacks"]

# Stack of active fallback recorders (innermost last). A ContextVar keeps
# concurrent threads / async tasks from seeing each other's records.
_RECORDERS: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "sharding_fallback_recorders", default=()
)


@contextlib.contextmanager
def record_fallbacks() -> Iterator[list]:
    """Scope replication-fallback recording to a block.

    Every ``spec_for`` call inside the block appends its fallback messages to
    the yielded list (and to any enclosing recorder — nesting composes).
    Outside any recorder, fallbacks are simply not recorded.

    Example::

        >>> from repro_torch.launch.mesh import make_chip_mesh
        >>> with record_fallbacks() as fb:
        ...     _ = spec_for(make_chip_mesh(1, 2), (3, 32), ("tp", "dp"), "t")
        >>> fb
        ["t: dim 0 (3) not divisible by tp('model',) -> replicated"]
    """
    rec: list = []
    token = _RECORDERS.set(_RECORDERS.get() + (rec,))
    try:
        yield rec
    finally:
        _RECORDERS.reset(token)


def _record_fallback(msg: str) -> None:
    for rec in _RECORDERS.get():
        rec.append(msg)
    # replication fallbacks double as observability signals: a structured
    # trace event plus a counter, both no-ops unless repro_torch.obs is active
    obs_trace.event("sharding.fallback", detail=msg)
    obs_metrics.inc(
        "sharding_fallback_total",
        help="Parameter/batch sharding dims replicated for non-divisibility.",
    )


def logical_to_mesh(mesh) -> dict:
    """Logical axis -> mesh axes. A chip mesh has no ``pod`` axis, so the
    JAX package's multi-pod branch (``dp`` -> ``("pod", "data")``) is not
    ported."""
    return {"tp": ("model",), "fsdp": ("data",), "dp": ("data",)}


def axes_size(mesh, axes: tuple) -> int:
    """Product of the named mesh-axis sizes (also used by ``fabric.shard``)."""
    return math.prod(mesh.shape[a] for a in axes)


def spec_for(mesh, shape: Sequence[int], logical: Sequence[Optional[str]], label: str = "") -> tuple:
    """The partition of ``shape`` over ``mesh``; drop (replicate) any dim
    that doesn't divide its mesh axes.

    Example::

        >>> from repro_torch.launch.mesh import make_chip_mesh
        >>> spec_for(make_chip_mesh(2, 4), (8, 6), ("tp", "dp"))
        ('model', 'data')
    """
    l2m = logical_to_mesh(mesh)
    entries = []
    for i, (dim, ax) in enumerate(zip(shape, logical)):
        if ax is None:
            entries.append(None)
            continue
        mesh_axes = l2m[ax]
        if dim % axes_size(mesh, mesh_axes) == 0:
            entries.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])
        else:
            entries.append(None)
            _record_fallback(
                f"{label}: dim {i} ({dim}) not divisible by {ax}{mesh_axes} -> replicated"
            )
    return tuple(entries)
