"""repro_torch.obs — host-side telemetry of the PyTorch port: spans, metrics,
their sinks and the fallback taxonomy (pure-Python copies of
``repro.obs.trace``, ``repro.obs.metrics``, ``repro.obs.sinks`` and
``repro.obs.fallback``)."""

from repro_torch.obs.fallback import (
    FALLBACK_REASONS,
    REASON_INELIGIBLE,
    REASON_INSUFFICIENT_DEVICES,
    REASON_NO_BUCKET,
    REASON_RAGGED_BATCH,
    REASON_REPLICATION_FALLBACK,
    REASON_REQUESTED_SEQUENTIAL,
    classify_fallback,
    record_fallback,
)
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    active,
    collecting,
    get_value,
    inc,
    observe,
    set_gauge,
)
from repro_torch.obs.sinks import JsonlSink, read_jsonl, write_prometheus
from repro_torch.obs.trace import Tracer, enabled, event, now_ns, span, tracing

__all__ = [
    "Tracer",
    "tracing",
    "span",
    "event",
    "enabled",
    "now_ns",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "collecting",
    "active",
    "inc",
    "set_gauge",
    "observe",
    "get_value",
    "JsonlSink",
    "read_jsonl",
    "write_prometheus",
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
