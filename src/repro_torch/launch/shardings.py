"""Divisibility-aware sharding rules: param tree -> spec tree (counterpart
of ``repro.launch.shardings``).

Logical axes:
  * ``tp``   -> mesh axis ("model",)            tensor parallelism
  * ``fsdp`` -> ("data",) or ("pod", "data")    parameter/optimizer sharding
  * ``dp``   -> ("data",) or ("pod", "data")    batch sharding

A dim that does not divide its assigned mesh axes falls back to replication
for that dim — every fallback is recorded so a caller sees exactly what got
replicated.

Fallback records are *scoped*, not global: wrap the spec-building calls in
``with record_fallbacks() as fb:`` and read ``fb`` afterwards. Callers that
don't open a recorder get no bookkeeping and leak nothing.

:func:`spec_for` returns a plain tuple, one entry per dim: a mesh axis name,
a tuple of names, or ``None`` (replicated); ``()`` replicates every dim. The
port has no ``NamedSharding``: the tree functions return trees of such
tuples, equal to ``tuple(NamedSharding.spec)`` of the JAX package's, and
:func:`shard_shape` gives what ``NamedSharding.shard_shape`` gives. Trees
are walked with ``repro_torch.tree`` (JAX's key paths).
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any, Iterator, Optional, Sequence

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.tree import map_with_path, tree_map

__all__ = [
    "logical_to_mesh",
    "spec_for",
    "axes_size",
    "param_shardings",
    "batch_shardings",
    "cache_shardings",
    "shard_shape",
    "record_fallbacks",
]

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
    """Logical axis -> mesh axes; a mesh with a ``pod`` axis shards data and
    parameters over ``("pod", "data")``."""
    dp = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
    return {"tp": ("model",), "fsdp": dp, "dp": dp}


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


def shard_shape(mesh, shape: Sequence[int], spec: tuple) -> tuple:
    """The shape of one device's shard: each dim divided by the product of
    its mesh axes (``NamedSharding.shard_shape``).

    Example::

        >>> from repro_torch.launch.mesh import make_chip_mesh
        >>> shard_shape(make_chip_mesh(2, 4), (8, 6, 3), ("model", "data"))
        (2, 3, 3)
    """
    out = []
    for i, dim in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        if ax is None:
            out.append(dim)
            continue
        size = axes_size(mesh, ax if isinstance(ax, tuple) else (ax,))
        if dim % size:
            raise ValueError(f"dim {i} ({dim}) of {tuple(shape)} does not divide over {ax} ({size})")
        out.append(dim // size)
    return tuple(out)


# ---------------------------------------------------------------------------
# Parameter rules (matched by leaf path suffix)
# ---------------------------------------------------------------------------

# name -> logical axes per trailing dim (leading stacked-L dims get None)
_PARAM_RULES: dict[str, tuple] = {
    # embeddings
    "tok": ("tp", "fsdp"),
    "unembed": ("fsdp", "tp"),
    # attention (flattened head dims shard over tp when divisible)
    "wq": ("fsdp", "tp"),
    "wk": ("fsdp", "tp"),
    "wv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"),
    "bq": ("tp",),
    "bk": ("tp",),
    "bv": ("tp",),
    # dense mlp
    "w_gate": ("fsdp", "tp"),
    "w_up": ("fsdp", "tp"),
    "w_down": ("tp", "fsdp"),
    # moe (expert dim over tp = expert parallelism)
    "router": ("fsdp", None),
    "moe/w_gate": ("tp", "fsdp", None),
    "moe/w_up": ("tp", "fsdp", None),
    "moe/w_down": ("tp", None, "fsdp"),
    # mamba2 (head-aligned dims over tp; guarded by head divisibility)
    "in_z": ("fsdp", "tp"),
    "in_x": ("fsdp", "tp"),
    "in_b": ("fsdp", None),
    "in_c": ("fsdp", None),
    "in_dt": ("fsdp", "tp"),
    "conv_x": (None, "tp"),
    "conv_b": (None, None),
    "conv_c": (None, None),
    "conv_x_bias": ("tp",),
    "conv_b_bias": (None,),
    "conv_c_bias": (None,),
    "A_log": ("tp",),
    "D": ("tp",),
    "dt_bias": ("tp",),
    "norm": ("tp",),
    "out_proj": ("tp", "fsdp"),
    # norms
    "ln": (None,),
    "ln1": (None,),
    "ln2": (None,),
    "ln_f": (None,),
    "mamba_ln": (None,),
}

_MAMBA_NAMES = {"in_z", "in_x", "in_dt", "conv_x", "conv_x_bias", "A_log", "D", "dt_bias", "norm", "out_proj"}


def _rule_for(joined: str) -> Optional[tuple]:
    """The rule of the longest key that ends the leaf's joined path (so
    ``moe/*`` wins over the plain names)."""
    best = None
    for key, rule in _PARAM_RULES.items():
        if joined.endswith(key):
            if best is None or len(key) > len(best[0]):
                best = (key, rule)
    return best[1] if best else None


def _mamba_heads_shardable(cfg, mesh) -> bool:
    tp = axes_size(mesh, ("model",))
    return bool(cfg.ssm_state) and cfg.ssm_heads % tp == 0


def param_shardings(mesh, params_shape: Any, cfg) -> Any:
    """Map a tree of parameter stand-ins (anything with ``.shape``) to
    specs."""
    mamba_tp = _mamba_heads_shardable(cfg, mesh)

    def one(joined, leaf):
        rule = _rule_for(joined)
        if rule is None:
            return ()
        # mamba leaves fall back to fsdp-only sharding when heads don't divide
        if joined.rsplit("/", 1)[-1] in _MAMBA_NAMES and "mamba" in joined and not mamba_tp:
            rule = tuple("fsdp" if ax == "fsdp" else None for ax in rule)
        logical = (None,) * (len(leaf.shape) - len(rule)) + rule
        return spec_for(mesh, leaf.shape, logical, label=joined)

    return map_with_path(one, params_shape)


# ---------------------------------------------------------------------------
# Activations / inputs / caches
# ---------------------------------------------------------------------------


def batch_shardings(mesh, batch_shape: Any) -> Any:
    """Token/label/embedding batches: batch dim over dp, rest replicated."""

    def one(leaf):
        logical = ("dp",) + (None,) * (len(leaf.shape) - 1)
        return spec_for(mesh, leaf.shape, logical, label="batch")

    return tree_map(one, batch_shape)


def cache_shardings(mesh, cache_shape: Any, cfg) -> Any:
    """KV / SSM cache specs for serve steps.

    KV cache leaves are (L, B, S, KV, hd): batch over dp when divisible;
    kv-heads over tp when divisible, otherwise the sequence dim goes over tp.
    Mamba state (L, B, H, P, N): heads over tp.
    """
    l2m = logical_to_mesh(mesh)
    dp_size = axes_size(mesh, l2m["dp"])
    tp_size = axes_size(mesh, l2m["tp"])

    def one(keys, leaf):
        shape = leaf.shape
        if keys.endswith("pos"):
            return ()
        if "conv" in keys:  # (L, B, W-1, C)
            logical = (None, "dp" if shape[1] % dp_size == 0 else None, None, None)
            return spec_for(mesh, shape, logical, label=keys)
        if keys.endswith("ssm"):  # (L, B, H, P, N)
            logical = (
                None,
                "dp" if shape[1] % dp_size == 0 else None,
                "tp" if shape[2] % tp_size == 0 else None,
                None,
                None,
            )
            return spec_for(mesh, shape, logical, label=keys)
        if len(shape) == 5:  # attn k/v (L, B, S, KV, hd)
            b_ok = shape[1] % dp_size == 0
            kv_ok = shape[3] % tp_size == 0
            logical = (
                None,
                "dp" if b_ok else None,
                None if kv_ok else "tp",
                "tp" if kv_ok else None,
                None,
            )
            if not b_ok and shape[2] % dp_size == 0 and kv_ok:
                # batch=1 long-context: spread the sequence over dp instead
                logical = (None, None, "dp", "tp", None)
            return spec_for(mesh, shape, logical, label=keys)
        return ()

    return map_with_path(one, cache_shape)

