"""Live exporters: JSONL metric snapshots, Prometheus text, Chrome trace.

``MetricsExporter`` is the always-on snapshot daemon: every
``interval_s`` it merges the registry shards and appends one JSON object
per line to ``metrics_path`` (a live tail-able feed: ``tail -f`` or
``jq`` work on a running server), and on ``stop()`` writes a final
snapshot plus, when configured, a Prometheus text-format dump and the
Chrome trace-event JSON of the span stream. All formatting runs on the
exporter thread — the dispatch hot path never pays for serialization.

``prometheus_text`` renders the registry in the Prometheus exposition
format (counters/gauges verbatim; histograms as the conventional
``_bucket``/``_sum``/``_count`` triplet with cumulative ``le`` buckets),
so a scrape endpoint or a textfile collector can serve it unchanged.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, Optional

from repro_torch.telemetry.registry import (MetricsRegistry, _NONPOS, format_key)


def prometheus_text(registry: MetricsRegistry) -> str:
    """Prometheus exposition text for every metric in the registry."""
    lines = []
    seen_types = set()
    for m in registry.metrics():
        base = m.name.replace(".", "_").replace("-", "_")
        if m.kind in ("counter", "gauge"):
            if base not in seen_types:
                lines.append(f"# TYPE {base} {m.kind}")
                seen_types.add(base)
            lines.append(f"{format_key(base, m.labels)} {m.value()}")
            continue
        # histogram: cumulative le buckets + _sum/_count
        if base not in seen_types:
            lines.append(f"# TYPE {base} histogram")
            seen_types.add(base)
        merged = m.merged()
        cum = 0
        for i in sorted(merged["buckets"]):
            cum += merged["buckets"][i]
            le = "0" if i == _NONPOS else repr(m.bucket_bounds(i)[1])
            labels = dict(m.labels)
            labels["le"] = le
            lines.append(f"{format_key(base + '_bucket', labels)} {cum}")
        labels = dict(m.labels)
        labels["le"] = "+Inf"
        lines.append(f"{format_key(base + '_bucket', labels)} "
                     f"{merged['count']}")
        lines.append(f"{format_key(base + '_sum', m.labels)} "
                     f"{merged['sum']}")
        lines.append(f"{format_key(base + '_count', m.labels)} "
                     f"{merged['count']}")
    return "\n".join(lines) + "\n"


class MetricsExporter:
    """Periodic snapshot thread: JSONL metrics feed + final Prometheus /
    Chrome-trace dumps. ``interval_s <= 0`` disables the periodic thread
    (final-only mode: one snapshot at ``stop()``)."""

    def __init__(self, telemetry, metrics_path: Optional[str] = None,
                 interval_s: float = 1.0,
                 trace_path: Optional[str] = None,
                 prometheus_path: Optional[str] = None):
        self.telemetry = telemetry
        self.metrics_path = metrics_path
        self.interval_s = interval_s
        self.trace_path = trace_path
        self.prometheus_path = prometheus_path
        self.snapshots_written = 0
        self.trace_events_written = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._fh = None
        self._lock = threading.Lock()

    # -- one snapshot line ---------------------------------------------
    def _write_snapshot(self, final: bool = False) -> Dict[str, Any]:
        snap = self.telemetry.snapshot()
        if final:
            snap["final"] = True
        with self._lock:
            if self.metrics_path is not None:
                if self._fh is None:
                    self._fh = open(self.metrics_path, "a",
                                    encoding="utf-8")
                self._fh.write(json.dumps(snap) + "\n")
                self._fh.flush()
            self.snapshots_written += 1
        return snap

    # -- daemon ---------------------------------------------------------
    def start(self) -> "MetricsExporter":
        if self.interval_s > 0 and self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop,
                                            name="metrics-exporter",
                                            daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self._write_snapshot()
            except Exception:       # a full disk must not kill the loop
                pass

    def stop(self) -> Dict[str, Any]:
        """Final snapshot + configured dumps; returns the final snapshot."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        snap = self._write_snapshot(final=True)
        if self.prometheus_path is not None:
            with open(self.prometheus_path, "w", encoding="utf-8") as fh:
                fh.write(prometheus_text(self.telemetry.registry))
        if self.trace_path is not None:
            self.trace_events_written = \
                self.telemetry.tracer.write_chrome_trace(self.trace_path)
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
        return snap

    def __enter__(self) -> "MetricsExporter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def read_jsonl(path: str):
    """Parse a JSONL metrics feed (raises on an invalid line) — the smoke
    stage's validity check and a convenient test helper."""
    out = []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
