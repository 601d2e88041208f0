"""Lightweight span/tracer API (a copy of ``repro.obs.trace`` for the
PyTorch port).

Tracing is *contextvar-scoped*: callers that open a :func:`tracing` block get
every span and event produced inside it (nesting composes — inner blocks also
feed enclosing tracers), and code outside any block pays near-zero cost —
:func:`span` returns one shared no-op singleton and :func:`event` returns
before building a record.

Instrumentation is strictly host-side: spans wall-clock Python-level work and
never touch device tensors. The only PyTorch integration is :func:`annotate`,
which wraps a region in ``torch.profiler.record_function`` (a profiler
timeline label) when tracing is enabled.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Iterator, List, Optional

from repro_torch.obs.sinks import JsonlSink

__all__ = ["Tracer", "tracing", "span", "event", "enabled", "annotate"]

# Stack of active tracers (innermost last). A ContextVar keeps concurrent
# threads / async serving tasks from seeing each other's spans.
_TRACERS: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "obs_tracers", default=()
)


class Tracer:
    """Collects finished spans and point events for one :func:`tracing` block.

    ``spans`` / ``events`` are lists of plain dicts (JSON-ready); when the
    block was opened with ``jsonl=path`` every record is also appended to
    that file as one JSON line the moment it is produced.

    Example::

        >>> from repro_torch.obs import tracing, span
        >>> with tracing() as tr:
        ...     with span("demo", layer=0):
        ...         pass
        >>> tr.spans[0]["name"], tr.spans[0]["attrs"]["layer"]
        ('demo', 0)
    """

    def __init__(self, sink: Optional[JsonlSink] = None):
        self.spans: List[dict] = []
        self.events: List[dict] = []
        self._sink = sink

    def _emit(self, record: dict) -> None:
        (self.spans if record["kind"] == "span" else self.events).append(record)
        if self._sink is not None:
            self._sink.write(record)


@contextlib.contextmanager
def tracing(jsonl=None) -> Iterator[Tracer]:
    """Scope span/event recording to a block.

    Every :func:`span` / :func:`event` inside the block lands on the
    yielded :class:`Tracer` (and on any enclosing tracer — nesting
    composes). ``jsonl`` optionally streams each record to a JSONL file
    (:class:`repro_torch.obs.JsonlSink`). Outside any block, instrumentation
    is a no-op.

    Example::

        >>> from repro_torch.obs import tracing, event
        >>> with tracing() as tr:
        ...     event("request.done", tokens=32)
        >>> tr.events[0]["name"]
        'request.done'
    """
    sink = JsonlSink(jsonl) if jsonl is not None else None
    tr = Tracer(sink)
    token = _TRACERS.set(_TRACERS.get() + (tr,))
    try:
        yield tr
    finally:
        _TRACERS.reset(token)
        if sink is not None:
            sink.close()


def enabled() -> bool:
    """Whether any :func:`tracing` block is active in this context.

    Example::

        >>> from repro_torch.obs import enabled, tracing
        >>> enabled()
        False
        >>> with tracing():
        ...     enabled()
        True
    """
    return bool(_TRACERS.get())


class _NullSpan:
    """The shared disabled-path span: every method is a no-op."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "attrs", "_tracers", "_t0")

    def __init__(self, name: str, attrs: dict, tracers: tuple):
        self.name = name
        self.attrs = attrs
        self._tracers = tracers
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def set(self, **attrs) -> None:
        """Attach attributes discovered mid-span (e.g. a resolved backend)."""
        self.attrs.update(attrs)

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        record = {
            "kind": "span",
            "name": self.name,
            "t_s": self._t0,
            "duration_s": t1 - self._t0,
            "attrs": self.attrs,
        }
        for tr in self._tracers:
            tr._emit(record)
        return False


def span(name: str, **attrs):
    """A wall-clock span context manager.

    With no active tracer this returns one shared no-op singleton (zero
    allocation, the documented disabled-path cost); with tracers active
    it records ``{name, t_s, duration_s, attrs}`` to every one of them
    on exit.

    Example::

        >>> from repro_torch.obs import span, tracing
        >>> with tracing() as tr:
        ...     with span("fabric.execute", layer="q_proj") as sp:
        ...         sp.set(tiles=4)
        >>> tr.spans[0]["attrs"]
        {'layer': 'q_proj', 'tiles': 4}
    """
    tracers = _TRACERS.get()
    if not tracers:
        return _NULL_SPAN
    return _Span(name, attrs, tracers)


def event(name: str, **attrs) -> None:
    """Record a point-in-time event (no duration) to every active tracer.

    No-op without an active :func:`tracing` block.

    Example::

        >>> from repro_torch.obs import event, tracing
        >>> with tracing() as tr:
        ...     event("fabric.fallback", reason="ragged_batch")
        >>> tr.events[0]["attrs"]["reason"]
        'ragged_batch'
    """
    tracers = _TRACERS.get()
    if not tracers:
        return
    record = {
        "kind": "event",
        "name": name,
        "t_s": time.perf_counter(),
        "attrs": attrs,
    }
    for tr in tracers:
        tr._emit(record)


def annotate(name: str):
    """A ``torch.profiler.record_function`` for ``name`` when tracing is
    enabled, else a null context — a label on the profiler timeline.

    Example::

        >>> from repro_torch.obs import annotate
        >>> with annotate("serve.prefill"):
        ...     pass  # launch the prefill here
    """
    if not _TRACERS.get():
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)
