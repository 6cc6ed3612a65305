"""Sharded metrics registry: counters, gauges, log-bucketed histograms.

The design constraint is PR 5's: instrumentation must not reintroduce the
shared-lock contention the dispatch hot path just shed. Every metric
therefore keeps one *cell* per writing thread (created lazily, registered
once under the registry lock) and the hot-path mutation is plain
arithmetic on that thread-private cell — no lock, no CAS, nothing another
dispatcher can wait behind. Readers (the exporter thread, tests,
``snapshot()``) merge the cells on demand; a merge may observe a cell
mid-update torn *across* fields (counts race ahead of sums by at most the
in-flight op) but each field is a single GIL-atomic slot, so totals are
always internally sane and monotone between snapshots.

Histograms are log-bucketed: bucket ``i`` covers ``[growth**i,
growth**(i+1))`` with ``growth = 2**0.25`` by default (≤ 19 % relative
quantile error, 4 buckets per octave). Merging shards is exact — bucket
counts add — so ``merge(shards) ≡ single-shard ingest`` (property-tested
in tests/test_telemetry.py).

The registry is self-measuring: every cell counts its ops, and
``snapshot()`` reports total ops, a calibrated per-op cost (measured once
on a scratch metric, off the hot path), the estimated cumulative overhead
seconds, and the measured cost of the snapshot itself — so "what does
telemetry cost?" is itself a metric (asserted end-to-end by
benchmarks/telemetry_overhead.py).
"""
from __future__ import annotations

import itertools
import math
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

clock = time.monotonic

#: global write-sequence for gauges: merge picks the latest write across
#: thread cells. itertools.count is GIL-atomic, so no lock on set().
_GAUGE_SEQ = itertools.count(1)

#: histogram bucket index for non-positive observations (log undefined)
_NONPOS = -(10 ** 9)

DEFAULT_GROWTH = 2 ** 0.25


def label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def format_key(name: str, labels: Dict[str, str]) -> str:
    """Prometheus-style flat key: ``name{k="v",...}`` (plain ``name``
    when unlabeled) — the snapshot/JSONL key format."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


class _Metric:
    """Base: lazy per-thread cells, registered under the registry lock
    (rare — once per writing thread) and merged by readers."""

    kind = "?"

    def __init__(self, registry: "MetricsRegistry", name: str,
                 labels: Dict[str, str]):
        self._registry = registry
        self.name = name
        self.labels = labels
        self.key = format_key(name, labels)
        self._tl = threading.local()
        self._cells: List[Any] = []

    def _new_cell(self):                    # pragma: no cover - abstract
        raise NotImplementedError

    def _cell(self):
        try:
            return self._tl.cell
        except AttributeError:
            cell = self._new_cell()
            with self._registry._lock:
                self._cells.append(cell)
            self._tl.cell = cell
            return cell

    def ops(self) -> int:
        with self._registry._lock:
            cells = list(self._cells)
        return sum(self._cell_ops(c) for c in cells)

    @staticmethod
    def _cell_ops(cell) -> int:             # pragma: no cover - abstract
        raise NotImplementedError


class Counter(_Metric):
    kind = "counter"

    # cell = [value, ops]
    def _new_cell(self):
        return [0.0, 0]

    @staticmethod
    def _cell_ops(cell) -> int:
        return cell[1]

    def add(self, v: float = 1.0) -> None:
        c = self._cell()
        c[0] += v
        c[1] += 1

    inc = add

    def value(self) -> float:
        with self._registry._lock:
            cells = list(self._cells)
        return sum(c[0] for c in cells)


class Gauge(_Metric):
    kind = "gauge"

    # cell = [write_seq, value, ops]
    def _new_cell(self):
        return [0, 0.0, 0]

    @staticmethod
    def _cell_ops(cell) -> int:
        return cell[2]

    def set(self, v: float) -> None:
        c = self._cell()
        c[1] = v
        c[0] = next(_GAUGE_SEQ)   # value first: a torn read sees old seq
        c[2] += 1

    def add(self, v: float = 1.0) -> None:
        """Gauge delta (e.g. depth up/down from one thread); last-write-
        wins semantics still apply across threads."""
        c = self._cell()
        self.set(c[1] + v)

    def value(self) -> float:
        with self._registry._lock:
            cells = list(self._cells)
        best_seq, best = 0, 0.0
        for c in cells:
            if c[0] >= best_seq:
                best_seq, best = c[0], c[1]
        return best


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, registry: "MetricsRegistry", name: str,
                 labels: Dict[str, str], growth: float = DEFAULT_GROWTH):
        super().__init__(registry, name, labels)
        if not growth > 1.0:
            raise ValueError(f"growth must be > 1, got {growth}")
        self.growth = growth
        self._lg = math.log(growth)

    # cell = [count, sum, min, max, ops, buckets_dict]
    def _new_cell(self):
        return [0, 0.0, math.inf, -math.inf, 0, {}]

    @staticmethod
    def _cell_ops(cell) -> int:
        return cell[4]

    def bucket_index(self, v: float) -> int:
        if v <= 0.0:
            return _NONPOS
        return int(math.floor(math.log(v) / self._lg))

    def bucket_bounds(self, i: int) -> Tuple[float, float]:
        if i == _NONPOS:
            return (-math.inf, 0.0)
        return (self.growth ** i, self.growth ** (i + 1))

    def observe(self, v: float) -> None:
        c = self._cell()
        c[0] += 1
        c[1] += v
        if v < c[2]:
            c[2] = v
        if v > c[3]:
            c[3] = v
        c[4] += 1
        b = c[5]
        i = _NONPOS if v <= 0.0 \
            else int(math.floor(math.log(v) / self._lg))
        b[i] = b.get(i, 0) + 1

    def merged(self) -> Dict[str, Any]:
        """Merge-on-snapshot: sum the per-thread shards (exact — bucket
        counts and moments are all additive except min/max)."""
        with self._registry._lock:
            cells = list(self._cells)
        count, total = 0, 0.0
        mn, mx = math.inf, -math.inf
        buckets: Dict[int, int] = {}
        for c in cells:
            count += c[0]
            total += c[1]
            mn = min(mn, c[2])
            mx = max(mx, c[3])
            for i, n in list(c[5].items()):
                buckets[i] = buckets.get(i, 0) + n
        return {"count": count, "sum": total,
                "min": mn if count else 0.0, "max": mx if count else 0.0,
                "buckets": buckets}

    def quantile(self, q: float,
                 merged: Optional[Dict[str, Any]] = None) -> float:
        """Bucketed quantile estimate: the upper bound of the bucket
        holding the q-th observation, clamped to the observed [min, max]
        — so the estimate is within one bucket width (factor ``growth``)
        of the true order statistic."""
        m = merged if merged is not None else self.merged()
        count = m["count"]
        if count == 0:
            return 0.0
        rank = max(1, math.ceil(q * count))
        seen = 0
        for i in sorted(m["buckets"]):
            seen += m["buckets"][i]
            if seen >= rank:
                hi = 0.0 if i == _NONPOS else self.growth ** (i + 1)
                return min(max(hi, m["min"]), m["max"])
        return m["max"]

    def summary(self) -> Dict[str, Any]:
        m = self.merged()
        count = m["count"]
        return {
            "count": count, "sum": m["sum"],
            "min": m["min"], "max": m["max"],
            "mean": m["sum"] / count if count else 0.0,
            "p50": self.quantile(0.50, m),
            "p95": self.quantile(0.95, m),
            "p99": self.quantile(0.99, m),
        }


class LabeledRegistry:
    """View over a base registry stamping constant labels (e.g.
    ``runtime="r0"``) onto every metric it creates. N federated runtimes
    share one process registry; without the stamp their ``svc.*`` /
    scheduler families would interleave indistinguishably in snapshots,
    Prometheus text, and the JSONL feed. The stamped labels win on
    collision (a runtime cannot relabel itself per call site). Everything
    else — collectors, snapshot, metrics — delegates to the base, so one
    exporter drains every runtime's view."""

    def __init__(self, base: "MetricsRegistry", labels: Dict[str, Any]):
        self.base = base
        self.labels = {k: str(v) for k, v in labels.items()}

    def counter(self, name: str, **labels) -> Counter:
        return self.base.counter(name, **{**labels, **self.labels})

    def gauge(self, name: str, **labels) -> Gauge:
        return self.base.gauge(name, **{**labels, **self.labels})

    def histogram(self, name: str, growth: Optional[float] = None,
                  **labels) -> Histogram:
        return self.base.histogram(name, growth=growth,
                                   **{**labels, **self.labels})

    def __getattr__(self, name):
        return getattr(self.base, name)


class MetricsRegistry:
    """Get-or-create metric factory + merge-on-snapshot reader."""

    def __init__(self, growth: float = DEFAULT_GROWTH):
        self.growth = growth
        self._lock = threading.RLock()
        self._metrics: Dict[Tuple[str, str, tuple], _Metric] = {}
        # weak collector callbacks run at snapshot time (queue depth,
        # partitioner lock-wait, ...): weakrefs so a dead runtime's
        # collector does not pin it (or crash the exporter) forever
        self._collectors: List[weakref.ref] = []
        self._snapshots = 0
        self._snapshot_s = 0.0
        self._calib_ns: Optional[float] = None

    # -- factories ------------------------------------------------------
    def _get(self, cls, name: str, labels: Dict[str, Any], **kw) -> _Metric:
        key = (cls.kind, name, label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(
                    self, name, dict(label_key(labels)), **kw)
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, growth: Optional[float] = None,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels,
                         growth=growth or self.growth)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    # -- collectors -----------------------------------------------------
    def add_collector(self, fn: Callable[[], None]) -> None:
        """Register a callback run at every snapshot (set gauges from
        live state). Held weakly: bound methods via WeakMethod, so a
        collected runtime simply drops out of the snapshot loop."""
        ref = weakref.WeakMethod(fn) if hasattr(fn, "__self__") \
            else weakref.ref(fn)
        with self._lock:
            self._collectors.append(ref)

    def _run_collectors(self) -> None:
        with self._lock:
            refs = list(self._collectors)
        live = []
        for ref in refs:
            fn = ref()
            if fn is None:
                continue
            live.append(ref)
            try:
                fn()
            except Exception:       # a broken collector must not kill
                pass                # the exporter thread
        with self._lock:
            self._collectors = [r for r in self._collectors if r in live
                                or r() is not None]

    # -- self-measurement ----------------------------------------------
    def _calibrate(self, n: int = 2000) -> float:
        """ns per hot-path op, measured on scratch metrics of a scratch
        registry (never touches live cells)."""
        if self._calib_ns is not None:
            return self._calib_ns
        scratch = MetricsRegistry.__new__(MetricsRegistry)
        scratch._lock = threading.RLock()
        scratch._metrics = {}
        scratch._collectors = []
        c = Counter(scratch, "calib", {})
        h = Histogram(scratch, "calib_h", {}, growth=self.growth)
        t0 = time.perf_counter()
        for i in range(n):
            c.add(1.0)
            h.observe(1e-6 * (i + 1))
        dt = time.perf_counter() - t0
        self._calib_ns = dt / (2 * n) * 1e9
        return self._calib_ns

    # -- the merge-on-snapshot read ------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        self._run_collectors()
        counters: Dict[str, float] = {}
        gauges: Dict[str, float] = {}
        hists: Dict[str, Dict[str, Any]] = {}
        ops = 0
        for m in self.metrics():
            ops += m.ops()
            if m.kind == "counter":
                counters[m.key] = m.value()
            elif m.kind == "gauge":
                gauges[m.key] = m.value()
            else:
                hists[m.key] = m.summary()
        calib = self._calibrate()
        dt = time.perf_counter() - t0
        self._snapshots += 1
        self._snapshot_s += dt
        return {
            "ts": time.time(), "mono": clock(),
            "counters": counters, "gauges": gauges, "histograms": hists,
            "self": {
                "ops": ops,
                "ns_per_op": round(calib, 1),
                "est_overhead_s": ops * calib * 1e-9,
                "snapshots": self._snapshots,
                "snapshot_s": self._snapshot_s,
            },
        }
