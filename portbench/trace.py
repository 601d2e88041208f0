"""The device trace of a traced run: ``torch.profiler`` over whole calls,
reduced to the device's intervals, and the host spans that label its idle
gaps.

Only device activity is recorded (``ProfilerActivity.CUDA``): the gaps are
labelled by the benchmark's own host spans and the program's
``serve.prefill`` / ``serve.decode`` spans, so the millions of host-side
operator events of a decode-heavy call are not needed. Timestamps are the
profiler's nanoseconds on the host's real-time clock, the clock of
``time.time_ns()``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import NamedTuple

__all__ = ["DeviceTrace", "reduce_events", "busy_seconds", "idle_gaps", "label_gaps", "top_ops", "device_events"]


class DeviceTrace(NamedTuple):
    by_name: dict  # kernel or copy name -> [count, seconds]
    launches: int  # kernels (copies and fills not counted)
    busy_s: float  # union of the device intervals inside the window
    window_s: float
    gaps: list  # (start_ns, end_ns) of idle stretches, longest first


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def device_events(prof) -> list:
    """(name, start_ns, end_ns) of every device activity a finished
    ``torch.profiler.profile`` recorded."""
    from torch.autograd import DeviceType

    results = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if results is None:
        raise RuntimeError("the profiler kept no Kineto results: no device trace to read")
    out = []
    for e in results.events():
        if e.device_type() == DeviceType.CUDA:
            s = e.start_ns()
            out.append((e.name(), s, s + e.duration_ns()))
    return out


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def busy_seconds(intervals, t0: int, t1: int) -> float:
    """Seconds of [t0, t1] (ns) covered by at least one interval: the union,
    so overlapping operations count once."""
    clipped = [(max(s, t0), min(e, t1)) for s, e in intervals if e > t0 and s < t1]
    return sum(e - s for s, e in _merge(clipped)) / 1e9


def idle_gaps(intervals, t0: int, t1: int) -> list:
    """(start_ns, end_ns) of the stretches of [t0, t1] no interval covers,
    longest first."""
    clipped = [(max(s, t0), min(e, t1)) for s, e in intervals if e > t0 and s < t1]
    gaps, at = [], t0
    for s, e in _merge(clipped):
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if t1 > at:
        gaps.append((at, t1))
    return sorted(gaps, key=lambda g: g[0] - g[1])


def reduce_events(events, t0: int, t1: int) -> DeviceTrace:
    """The device events of a window [t0, t1] (ns) reduced to what the
    per-layer readers take."""
    by_name: dict = defaultdict(lambda: [0, 0.0])
    for name, s, e in events:
        rec = by_name[name]
        rec[0] += 1
        rec[1] += (e - s) / 1e9
    intervals = [(s, e) for _, s, e in events]
    return DeviceTrace(
        by_name=dict(by_name),
        launches=sum(c for n, (c, _) in by_name.items() if _is_kernel(n)),
        busy_s=busy_seconds(intervals, t0, t1),
        window_s=(t1 - t0) / 1e9,
        gaps=idle_gaps(intervals, t0, t1),
    )


def label_gaps(gaps, spans, n: int = 10) -> list:
    """The ``n`` longest gaps as ``[label, seconds]``. A gap's label is the
    innermost host span (the shortest) that holds its midpoint, with the
    call it belongs to; spans are ``(name, start_ns, end_ns, call index)``."""
    out = []
    for s, e in gaps[:n]:
        mid = (s + e) // 2
        holding = [sp for sp in spans if sp[1] <= mid <= sp[2]]
        if holding:
            name, _, _, idx = min(holding, key=lambda sp: sp[2] - sp[1])
            label = f"{name} (call {idx})" if idx is not None else name
        else:
            label = "outside the calls"
        out.append([label, (e - s) / 1e9])
    return out


def top_ops(by_name: dict, n: int = 10) -> list:
    """The ``n`` device operations that took the most time, ``[name, seconds]``."""
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:n]
    return [[name[:160], sec] for name, (_, sec) in ranked]
