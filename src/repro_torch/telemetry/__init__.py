"""Always-on observability for the serving stack.

The port's copy of ``repro.telemetry``, whole, with its imports rewritten.

The paper's whole §3.3 method is *measure the host-side overheads before
optimizing them*; this package makes that measurement continuous instead
of post-hoc. Three pieces:

  * ``MetricsRegistry`` — counters / gauges / log-bucketed histograms
    with per-thread shards (lock-free hot path, merge-on-snapshot), so
    instrumentation cannot reintroduce the shared-lock contention the
    range partitioner removed from dispatch;
  * ``SpanTracer`` — chunk-lifecycle spans (Tc1→Tc3 / Tg1→Tg5 plus
    queue/steal/requeue/admission events) behind a ``sample_rate`` knob,
    exported as Chrome trace-event JSON (Perfetto / chrome://tracing);
  * ``MetricsExporter`` — a periodic snapshot thread emitting JSONL,
    Prometheus text, and the trace file.

A ``Telemetry`` object bundles one registry + one tracer. Instrumented
components take ``telemetry=None`` (→ the process-wide default instance:
always-on) or an explicit instance; pass
``telemetry=repro_torch.telemetry.OFF`` to run genuinely uninstrumented.
The registry is self-measuring — ``snapshot()["self"]`` reports its own
estimated overhead.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from repro_torch.telemetry.registry import (Counter, Gauge, Histogram,
                                      LabeledRegistry, MetricsRegistry,
                                      format_key)
from repro_torch.telemetry.spans import LabeledTracer, SpanTracer
from repro_torch.telemetry.exporters import (MetricsExporter, prometheus_text,
                                       read_jsonl)

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

    def labeled(self, **labels) -> "TelemetryView":
        """Per-runtime facet of this instance: same metric storage and
        trace ring, but every metric carries ``labels`` and every span /
        epoch tag is namespaced — how N federated runtimes share one
        exporter without interleaving their families (e.g.
        ``tel.labeled(runtime="r0")``)."""
        return TelemetryView(self, labels)


class TelemetryView:
    """A ``Telemetry`` facet with constant labels stamped on (see
    ``Telemetry.labeled``). ``resolve()`` passes it through like any
    instance; ``snapshot()`` is the base's merged view."""

    def __init__(self, base: Telemetry, labels: Dict[str, Any]):
        self.base = base
        self.labels = {k: str(v) for k, v in labels.items()}
        self.registry = LabeledRegistry(base.registry, self.labels)
        self.tracer = LabeledTracer(
            base.tracer, "/".join(self.labels.values()) or "view")

    def snapshot(self) -> Dict[str, Any]:
        return self.base.snapshot()

    def labeled(self, **labels) -> "TelemetryView":
        return TelemetryView(self.base, {**self.labels, **labels})


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
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "MetricsExporter",
    "LabeledRegistry", "LabeledTracer", "SpanTracer", "Telemetry",
    "TelemetryView", "OFF", "default", "resolve",
    "prometheus_text", "read_jsonl", "format_key",
]
