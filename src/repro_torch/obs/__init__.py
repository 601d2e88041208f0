"""repro_torch.obs — host-side telemetry of the PyTorch port: spans, metrics
and their sinks (pure-Python copies of ``repro.obs.trace``,
``repro.obs.metrics`` and ``repro.obs.sinks``)."""

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
from repro_torch.obs.trace import Tracer, annotate, enabled, event, span, tracing

__all__ = [
    "Tracer",
    "tracing",
    "span",
    "event",
    "enabled",
    "annotate",
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
]
