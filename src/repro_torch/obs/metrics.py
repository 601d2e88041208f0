"""Metrics registry: counters, gauges, histograms (a copy of
``repro.obs.metrics`` for the PyTorch port).

Collection is *contextvar-scoped* like ``obs.trace``: instrumented code calls
the module-level helpers (:func:`inc`, :func:`set_gauge`, :func:`observe`),
which are no-ops unless a :func:`collecting` block is active — so callers
carry their instrumentation unconditionally and pay only a ContextVar read
when nobody is listening. All recorded values are host Python numbers
(counts, wall-clock seconds); device tensors never enter the registry.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

__all__ = [
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
]

# Stack of active registries (innermost last), concurrency-safe like the
# sharding fallback recorders.
_REGISTRIES: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "obs_registries", default=()
)

# Seconds-oriented default buckets, from sub-microsecond to multi-second spans.
DEFAULT_BUCKETS = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0, float("inf"))

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: dict) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _label_str(key: LabelKey) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class Counter:
    """A monotonically increasing labeled counter.

    Example::

        >>> from repro_torch.obs import MetricsRegistry
        >>> c = MetricsRegistry().counter("fabric_requests_total")
        >>> c.inc(path="fused"); c.inc(2, path="fallback")
        >>> c.value(path="fused"), c.value(path="fallback")
        (1.0, 2.0)
    """

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.samples: Dict[LabelKey, float] = {}

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {value})")
        key = _label_key(labels)
        self.samples[key] = self.samples.get(key, 0.0) + value

    def value(self, **labels) -> float:
        return self.samples.get(_label_key(labels), 0.0)


class Gauge:
    """A labeled gauge (set to the latest observation).

    Example::

        >>> from repro_torch.obs import MetricsRegistry
        >>> g = MetricsRegistry().gauge("fabric_link_clock_calibration")
        >>> g.set(2.96e4)
        >>> g.value()
        29600.0
    """

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.samples: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels) -> None:
        self.samples[_label_key(labels)] = float(value)

    def value(self, **labels) -> float:
        return self.samples.get(_label_key(labels), 0.0)


class Histogram:
    """A labeled cumulative-bucket histogram (Prometheus semantics:
    each ``le`` bucket counts observations <= its bound).

    Example::

        >>> from repro_torch.obs import MetricsRegistry
        >>> h = MetricsRegistry().histogram("lat_seconds", buckets=(0.1, 1.0, float("inf")))
        >>> h.observe(0.05); h.observe(0.5)
        >>> h.count(), h.sum()
        (2, 0.55)
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "", buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        self.buckets = tuple(buckets)
        if self.buckets[-1] != float("inf"):
            self.buckets = self.buckets + (float("inf"),)
        # label key -> (per-bucket counts, sum, count)
        self.samples: Dict[LabelKey, list] = {}

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        if key not in self.samples:
            self.samples[key] = [[0] * len(self.buckets), 0.0, 0]
        counts, _, _ = self.samples[key]
        for i, bound in enumerate(self.buckets):
            if value <= bound:
                counts[i] += 1
        self.samples[key][1] += float(value)
        self.samples[key][2] += 1

    def count(self, **labels) -> int:
        s = self.samples.get(_label_key(labels))
        return s[2] if s else 0

    def sum(self, **labels) -> float:
        s = self.samples.get(_label_key(labels))
        return s[1] if s else 0.0


class MetricsRegistry:
    """Get-or-create home for every metric of one :func:`collecting` block.

    Example::

        >>> from repro_torch.obs import MetricsRegistry
        >>> reg = MetricsRegistry()
        >>> reg.counter("fabric_requests_total").inc(path="fused")
        >>> sorted(reg.names())
        ['fabric_requests_total']
        >>> "fabric_requests_total" in reg.prometheus_text()
        True
    """

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, cls, name: str, help: str, **kwargs):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, help=help, **kwargs)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise ValueError(
                f"metric {name!r} already registered as {m.kind}, not {cls.kind}"
            )
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def snapshot(self) -> dict:
        """JSON-ready dump: metric name -> kind + labeled samples."""
        out = {}
        for name, m in sorted(self._metrics.items()):
            if m.kind == "histogram":
                out[name] = {
                    "kind": m.kind,
                    "samples": [
                        {"labels": dict(k), "count": s[2], "sum": s[1]}
                        for k, s in sorted(m.samples.items())
                    ],
                }
            else:
                out[name] = {
                    "kind": m.kind,
                    "samples": [
                        {"labels": dict(k), "value": v}
                        for k, v in sorted(m.samples.items())
                    ],
                }
        return out

    def prometheus_text(self) -> str:
        """The Prometheus text exposition of every registered metric."""
        lines: List[str] = []
        for name, m in sorted(self._metrics.items()):
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            if m.kind == "histogram":
                for key, (counts, total, count) in sorted(m.samples.items()):
                    for bound, c in zip(m.buckets, counts):
                        le = "+Inf" if bound == float("inf") else repr(bound)
                        labels = _label_str(key + (("le", le),))
                        lines.append(f"{name}_bucket{labels} {c}")
                    lines.append(f"{name}_sum{_label_str(key)} {total}")
                    lines.append(f"{name}_count{_label_str(key)} {count}")
            else:
                for key, v in sorted(m.samples.items()):
                    val = int(v) if float(v).is_integer() else v
                    lines.append(f"{name}{_label_str(key)} {val}")
        return "\n".join(lines) + ("\n" if lines else "")


@contextlib.contextmanager
def collecting(registry: Optional[MetricsRegistry] = None) -> Iterator[MetricsRegistry]:
    """Scope metric collection to a block.

    Every module-level :func:`inc` / :func:`set_gauge` / :func:`observe`
    inside the block lands on the yielded registry (and on enclosing
    registries — nesting composes). Outside any block the helpers are
    no-ops.

    Example::

        >>> from repro_torch.obs import collecting, inc
        >>> with collecting() as reg:
        ...     inc("fabric_requests_total", path="fused")
        >>> reg.counter("fabric_requests_total").value(path="fused")
        1.0
    """
    reg = registry if registry is not None else MetricsRegistry()
    token = _REGISTRIES.set(_REGISTRIES.get() + (reg,))
    try:
        yield reg
    finally:
        _REGISTRIES.reset(token)


def active() -> bool:
    """Whether any :func:`collecting` block is active in this context.

    Example::

        >>> from repro_torch.obs import active, collecting
        >>> active()
        False
        >>> with collecting():
        ...     active()
        True
    """
    return bool(_REGISTRIES.get())


def inc(name: str, value: float = 1.0, help: str = "", **labels) -> None:
    """Increment counter ``name`` on every active registry (no-op when
    collection is disabled).

    Example::

        >>> from repro_torch.obs import collecting, inc
        >>> inc("noop_total")  # no registry: silently dropped
        >>> with collecting() as reg:
        ...     inc("fabric_fallback_total", reason="ragged_batch")
        >>> reg.counter("fabric_fallback_total").value(reason="ragged_batch")
        1.0
    """
    for reg in _REGISTRIES.get():
        reg.counter(name, help=help).inc(value, **labels)


def set_gauge(name: str, value: float, help: str = "", **labels) -> None:
    """Set gauge ``name`` on every active registry (no-op when disabled).

    Example::

        >>> from repro_torch.obs import collecting, set_gauge
        >>> with collecting() as reg:
        ...     set_gauge("fabric_link_clock_calibration", 2.9e4)
        >>> reg.gauge("fabric_link_clock_calibration").value()
        29000.0
    """
    for reg in _REGISTRIES.get():
        reg.gauge(name, help=help).set(value, **labels)


def observe(name: str, value: float, help: str = "", **labels) -> None:
    """Record ``value`` into histogram ``name`` on every active registry
    (no-op when disabled).

    Example::

        >>> from repro_torch.obs import collecting, observe
        >>> with collecting() as reg:
        ...     observe("serve_prefill_seconds", 0.12)
        >>> reg.histogram("serve_prefill_seconds").count()
        1
    """
    for reg in _REGISTRIES.get():
        reg.histogram(name, help=help).observe(value, **labels)


def get_value(name: str, **labels) -> float:
    """Read counter/gauge ``name`` from the innermost active registry
    (0.0 when disabled or unregistered) — how the serve summary line
    reads back the counters instrumented code just incremented.

    Example::

        >>> from repro_torch.obs import collecting, get_value, inc
        >>> with collecting():
        ...     inc("fabric_requests_total", path="fused")
        ...     get_value("fabric_requests_total", path="fused")
        1.0
    """
    regs = _REGISTRIES.get()
    if not regs:
        return 0.0
    m = regs[-1]._metrics.get(name)
    if m is None or m.kind == "histogram":
        return 0.0
    return m.value(**labels)
