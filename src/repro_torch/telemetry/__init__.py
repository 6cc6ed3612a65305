"""Metrics and chunk-lifecycle spans for the port's scheduler stack.

The port's copy of ``repro.telemetry``, cut to what the scheduler and the
partitioner use: a ``Telemetry`` bundles one ``MetricsRegistry`` (per-thread
shards, merge-on-snapshot) and one ``SpanTracer`` (Tc1→Tc3 / Tg1→Tg5 spans
behind ``sample_rate``). Components take ``telemetry=None`` (the process-wide
default instance), an explicit instance, or ``OFF`` to run uninstrumented.
The exporters and the labeled per-runtime views (federation) are not part
of this slice.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from repro_torch.telemetry.registry import (Counter, Gauge, Histogram,
                                            MetricsRegistry, format_key)
from repro_torch.telemetry.spans import SpanTracer

#: sentinel: run uninstrumented (resolve() maps it — and False — to None)
OFF = object()


class Telemetry:
    """One registry + one tracer: the unit components are wired with."""

    def __init__(self, sample_rate: float = 1.0,
                 max_trace_events: int = 200_000):
        self.registry = MetricsRegistry()
        self.tracer = SpanTracer(sample_rate=sample_rate,
                                 max_events=max_trace_events)

    def snapshot(self) -> Dict[str, Any]:
        snap = self.registry.snapshot()
        snap["trace"] = {"emitted": self.tracer.emitted,
                         "retained": len(self.tracer),
                         "dropped": self.tracer.dropped,
                         "sample_rate": self.tracer.sample_rate}
        return snap


_default: Optional[Telemetry] = None
_default_lock = threading.Lock()


def default() -> Telemetry:
    """The process-wide always-on instance (created lazily). Long-lived:
    counters only ever grow; the tracer ring and epoch-tag map are
    bounded."""
    global _default
    with _default_lock:
        if _default is None:
            _default = Telemetry()
        return _default


def resolve(telemetry) -> Optional[Telemetry]:
    """Normalize a component's ``telemetry=`` argument: ``None`` → the
    always-on default, ``OFF``/``False`` → uninstrumented (None), an
    instance → itself."""
    if telemetry is None:
        return default()
    if telemetry is OFF or telemetry is False:
        return None
    return telemetry


__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "SpanTracer",
    "Telemetry", "OFF", "default", "resolve", "format_key",
]
