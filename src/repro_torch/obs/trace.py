"""Lightweight span/tracer API (a copy of ``repro.obs.trace`` for the
PyTorch port).

Tracing is *contextvar-scoped*: callers that open a :func:`tracing` block get
every span and event produced inside it (nesting composes — inner blocks also
feed enclosing tracers), and code outside any block pays near-zero cost —
:func:`span` returns one shared no-op singleton and :func:`event` returns
before building a record.

Instrumentation is strictly host-side: spans wall-clock Python-level work and
never touch device tensors. Each span record carries its ``id``, the ``id``
of the span it was opened in (``parent``), and ``start_ns`` / ``end_ns`` on
the clock of :func:`now_ns`, the clock ``torch.profiler`` stamps its events
with, so a device trace and the spans that launched its work line up with
no offset.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import time
from typing import Iterator, List, Optional

from repro_torch.obs.sinks import JsonlSink

__all__ = ["Tracer", "tracing", "span", "event", "enabled", "now_ns"]

# Stack of active tracers (innermost last). A ContextVar keeps concurrent
# threads / async serving tasks from seeing each other's spans.
_TRACERS: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "obs_tracers", default=()
)
# The innermost open recorded span of this context (None outside any): the
# parent of the next span opened.
_OPEN: contextvars.ContextVar = contextvars.ContextVar("obs_open_span", default=None)
_IDS = itertools.count(1)


def now_ns() -> int:
    """The spans' clock: the host's real-time clock in integer nanoseconds
    (``time.time_ns``).

    ``torch.profiler`` stamps its host and device events on this clock (Unix
    time in ns), so a span's ``start_ns`` / ``end_ns`` compare directly with
    the timestamps of the work launched inside it. ``time.perf_counter``
    would need an offset to the profiler's clock, read at one instant and
    drifting after it.
    """
    return time.time_ns()


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
    __slots__ = ("name", "attrs", "id", "_tracers", "_parent", "_token", "_start", "_t0")

    def __init__(self, name: str, attrs: dict, tracers: tuple):
        self.name = name
        self.attrs = attrs
        self.id = next(_IDS)
        self._tracers = tracers
        self._parent = None
        self._token = None
        self._start = 0
        self._t0 = 0.0

    def __enter__(self):
        self._parent = _OPEN.get()
        self._token = _OPEN.set(self)
        self._t0 = time.perf_counter()
        self._start = now_ns()
        return self

    def set(self, **attrs) -> None:
        """Attach attributes discovered mid-span (e.g. a resolved backend)."""
        self.attrs.update(attrs)

    def _parent_in(self, tr: Tracer):
        """The id of the innermost enclosing span that ``tr`` records, or None."""
        p = self._parent
        while p is not None and not any(t is tr for t in p._tracers):
            p = p._parent
        return None if p is None else p.id

    def __exit__(self, *exc):
        end = now_ns()
        t1 = time.perf_counter()
        _OPEN.reset(self._token)
        for tr in self._tracers:
            tr._emit({
                "kind": "span",
                "name": self.name,
                "id": self.id,
                "parent": self._parent_in(tr),
                "start_ns": self._start,
                "end_ns": end,
                "t_s": self._t0,
                "duration_s": t1 - self._t0,
                "attrs": self.attrs,
            })
        return False


def span(name: str, **attrs):
    """A wall-clock span context manager.

    With no active tracer this returns one shared no-op singleton (zero
    allocation, the documented disabled-path cost); with tracers active
    it records ``{name, id, parent, start_ns, end_ns, t_s, duration_s,
    attrs}`` to every one of them on exit. ``parent`` is the ``id`` of the
    innermost span open around it that the same tracer records (None at
    the top); ``start_ns`` / ``end_ns`` are on :func:`now_ns`'s clock;
    ``t_s`` and ``duration_s`` are ``time.perf_counter`` seconds, as the
    JSONL log's readers take them.

    Example::

        >>> from repro_torch.obs import span, tracing
        >>> with tracing() as tr:
        ...     with span("fabric.execute", layer="q_proj") as sp:
        ...         sp.set(tiles=4)
        >>> tr.spans[0]["attrs"]
        {'layer': 'q_proj', 'tiles': 4}
        >>> with tracing() as tr:
        ...     with span("outer"):
        ...         with span("inner"):
        ...             pass
        >>> inner, outer = tr.spans
        >>> inner["parent"] == outer["id"], outer["parent"]
        (True, None)
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

