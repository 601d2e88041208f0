"""Canonical fallback taxonomy + the structured-event emitter (a copy of
``repro.obs.fallback`` for the PyTorch port).

Every place the fabric stack degrades from its fused ``shard_map`` path —
ragged runtime batches, replication fallbacks in sharding resolution,
explicitly requested sequential execution — funnels through
:func:`record_fallback`, which emits one ``fabric.fallback`` trace event
*and* increments the ``fabric_fallback_total{reason=...}`` counter. The
reason strings below are the JAX package's, a wire format, not prose.

``insufficient_devices`` stays in the taxonomy, but the port never emits it:
every chip of a mesh runs on one torch device, so no mesh lacks devices.
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.obs import metrics, trace

__all__ = [
    "REASON_RAGGED_BATCH",
    "REASON_INSUFFICIENT_DEVICES",
    "REASON_REPLICATION_FALLBACK",
    "REASON_REQUESTED_SEQUENTIAL",
    "REASON_INELIGIBLE",
    "REASON_NO_BUCKET",
    "FALLBACK_REASONS",
    "classify_fallback",
    "record_fallback",
]

#: Runtime batch not divisible by the mesh's data axis — the fused
#: program cannot shard it, execution drops to the per-layer/per-node loop.
REASON_RAGGED_BATCH = "ragged_batch"
#: Host exposes fewer devices than the mapping needs chips (the JAX
#: package's reason; never emitted by the port).
REASON_INSUFFICIENT_DEVICES = "insufficient_devices"
#: Sharding resolution realized a smaller mesh than requested and
#: replicated the remainder.
REASON_REPLICATION_FALLBACK = "replication_fallback"
#: Caller explicitly asked for the sequential backend.
REASON_REQUESTED_SEQUENTIAL = "requested_sequential"
#: Catch-all for any other compile-time eligibility problem.
REASON_INELIGIBLE = "ineligible"
#: The bucketed program cache had no bucket large enough for the request
#: batch.
REASON_NO_BUCKET = "no_bucket"

FALLBACK_REASONS = (
    REASON_RAGGED_BATCH,
    REASON_INSUFFICIENT_DEVICES,
    REASON_REPLICATION_FALLBACK,
    REASON_REQUESTED_SEQUENTIAL,
    REASON_INELIGIBLE,
    REASON_NO_BUCKET,
)


def classify_fallback(problems: Sequence[str]) -> str:
    """Map eligibility problem strings (from ``resolve_backend`` /
    ``program_eligibility``) onto the canonical reason taxonomy.

    Example::

        >>> from repro_torch.obs import classify_fallback
        >>> classify_fallback(["host has 8 jax device(s) < 16 chips (set XLA_FLAGS=...)"])
        'insufficient_devices'
        >>> classify_fallback(["replication fallback: realized 2x2 != mesh 4x4"])
        'replication_fallback'
        >>> classify_fallback(["weights not quantized"])
        'ineligible'
    """
    joined = " | ".join(problems)
    if "jax device" in joined:
        return REASON_INSUFFICIENT_DEVICES
    if "replication fallback" in joined:
        return REASON_REPLICATION_FALLBACK
    return REASON_INELIGIBLE


def record_fallback(component: str, reason: str, detail: str = "") -> None:
    """Emit one structured fallback record: a ``fabric.fallback`` trace
    event (when tracing) plus a ``fabric_fallback_total{reason=...}``
    counter increment (when collecting). No-op with observability off.

    Example::

        >>> from repro_torch.obs import collecting, record_fallback, tracing
        >>> with tracing() as tr, collecting() as reg:
        ...     record_fallback("fabric.program", "ragged_batch", "batch 3 % data 2 != 0")
        >>> tr.events[0]["attrs"]["reason"]
        'ragged_batch'
        >>> reg.counter("fabric_fallback_total").value(reason="ragged_batch")
        1.0
    """
    trace.event("fabric.fallback", component=component, reason=reason, detail=detail)
    metrics.inc(
        "fabric_fallback_total",
        help="Fused-path fallbacks by canonical reason.",
        reason=reason,
    )
