"""Telemetry sinks: JSONL event log + Prometheus-style text exposition (a
copy of ``repro.obs.sinks`` for the PyTorch port).

Two on-disk formats, both append/overwrite-atomic at the record level:

  * **JSONL** — one JSON object per line, written the moment a span/event
    finishes (:class:`JsonlSink`, fed by ``obs.trace.tracing(jsonl=...)``).
    :func:`read_jsonl` is the strict (parse-clean) loader.
  * **Prometheus text exposition** — ``# HELP`` / ``# TYPE`` headers plus
    one ``name{label="v"} value`` sample line per labeled series, the
    format any Prometheus-compatible scraper ingests
    (:func:`write_prometheus`, built on
    ``MetricsRegistry.prometheus_text``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional

__all__ = ["JsonlSink", "read_jsonl", "write_prometheus"]


class JsonlSink:
    """Append telemetry records to a file, one JSON object per line.

    The file is opened lazily on the first :meth:`write` and flushed per
    record, so a crashed serve process still leaves a parseable log of
    everything that finished. Non-JSON-serializable attribute values are
    stringified rather than raised on — a telemetry sink must never take
    the serving path down.

    Example::

        >>> import tempfile, os
        >>> path = os.path.join(tempfile.mkdtemp(), "obs.jsonl")
        >>> sink = JsonlSink(path)
        >>> sink.write({"kind": "event", "name": "demo"})
        >>> sink.close()
        >>> read_jsonl(path)[0]["name"]
        'demo'
    """

    def __init__(self, path):
        self.path = Path(path)
        self._fh = None

    def write(self, record: dict) -> None:
        if self._fh is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = self.path.open("a")
        self._fh.write(json.dumps(record, default=str) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def read_jsonl(path) -> List[dict]:
    """Load a JSONL telemetry log, raising on any unparseable line.

    Example::

        >>> import tempfile, os
        >>> path = os.path.join(tempfile.mkdtemp(), "obs.jsonl")
        >>> sink = JsonlSink(path); sink.write({"a": 1}); sink.close()
        >>> read_jsonl(path)
        [{'a': 1}]
    """
    out = []
    with Path(path).open() as fh:
        for i, line in enumerate(fh):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i + 1}: unparseable JSONL line: {e}") from e
    return out


def write_prometheus(registry, path) -> Optional[Path]:
    """Write a registry's Prometheus text exposition to ``path``
    (overwrite; scrape files are snapshots, not logs).

    Example::

        >>> import tempfile, os
        >>> from repro_torch.obs import MetricsRegistry, write_prometheus
        >>> reg = MetricsRegistry()
        >>> reg.counter("requests_total").inc()
        >>> path = os.path.join(tempfile.mkdtemp(), "metrics.prom")
        >>> _ = write_prometheus(reg, path)
        >>> "requests_total 1" in open(path).read()
        True
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(registry.prometheus_text())
    return path
