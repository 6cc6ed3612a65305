"""Heterogeneous dynamic partitioner — the paper's §3.2 (Partitioner_H).

Policy (Navarro et al. heuristic, eqs. 3–4):
  * an ACCEL group always receives its tuned optimal chunk G;
  * any other group receives C = G_ref · λ_self / λ_ref, where ref is the
    (fastest) accelerator group — i.e. every chunk is sized to take the same
    wall time as the accelerator's chunk, balancing load while every device
    runs at its throughput-optimal size;
  * if no accelerator exists, chunks are proportional to a base quantum.

The partitioner is work-conserving: it never hands out more iterations than
remain, and the final chunks shrink to exhaust the space exactly (property-
tested in tests/test_properties.py).

Two chunk modes (the dispatch hot path):

``chunk_mode="range"`` (default) — zero-contention dispatch. Each group
owns a private index *range* sized by its λ-share of the remaining space;
its dispatcher carves chunks out of it with plain arithmetic under a
private (and therefore uncontended in steady state) lock. The global lock
is touched only to *refill* an empty range from the unassigned space and
to *steal* from the largest remaining range once the space runs dry — so
a chunk grant never waits behind another group's Filter₁. Work
conservation and requeue semantics are identical to the paper path
(property-tested: same covered iteration set); the one behavioral
difference is that a group's chunk size is recomputed per *refill*, not
per token, so λ feedback quantizes to range granularity.

``chunk_mode="paper"`` — the original lock-per-token path (one global
lock serializing every ``next_token``), kept bit-compatible for
paper-faithful runs and as the dispatch-overhead benchmark baseline.

The global lock is wait-instrumented in both modes
(``contention_stats()``), which is what benchmarks/dispatch_overhead.py
reports as lock-wait time; the range-mode fast path never touches it.

The partitioner is *epoch-reusable*: one instance serves successive
iteration spaces on the persistent scheduler runtime. Group membership
(including groups removed by death or elastic leave), the accelerator
reference, and — via the shared ThroughputTracker — the λ-EWMAs all carry
across epochs; ``begin_epoch(space)`` swaps in the next space, and
``next_token``/``requeue`` accept an explicit space so overlapping epochs
(one group draining epoch N while another starts N+1) never mix ranges.
A group that dies or leaves returns its unconsumed ranges to their spaces
(count conservation, like ``requeue``), so no assigned-but-unrun work is
ever lost with its owner.
"""
from __future__ import annotations

import threading
import time
import weakref
from typing import Dict, Optional

from repro_torch import telemetry as telemetry_mod
from repro_torch.core.locks import TimedLock
from repro_torch.core.throughput import ThroughputTracker
from repro_torch.core.types import Chunk, DeviceKind, GroupSpec, IterationSpace, \
    Token

clock = time.monotonic

CHUNK_MODES = ("range", "paper")

# compat alias: the wait-instrumented lock moved to repro_torch.core.locks so
# the throughput tracker can share it without a circular import
_TimedLock = TimedLock


class _GroupRange:
    """Private [lo, hi) slice of one space owned by one group. ``lock``
    is touched by the owner's dispatcher and, rarely, a thief — never by
    the other dispatchers' steady-state grants."""

    __slots__ = ("lo", "hi", "chunk", "lock")

    def __init__(self):
        self.lo = 0
        self.hi = 0
        self.chunk = 1              # per-refill chunk size (λ-sized)
        self.lock = threading.Lock()

    @property
    def remaining(self) -> int:
        return self.hi - self.lo


class HeterogeneousPartitioner:
    def __init__(self, space: IterationSpace, groups: Dict[str, GroupSpec],
                 tracker: ThroughputTracker,
                 base_quantum: int = 256, chunk_mode: str = "range",
                 refill_chunks: int = 8, adaptive_refill: bool = False,
                 telemetry=None):
        if chunk_mode not in CHUNK_MODES:
            raise ValueError(f"chunk_mode must be one of {CHUNK_MODES}, "
                             f"got {chunk_mode!r}")
        self.space = space
        self.groups = dict(groups)
        self.tracker = tracker
        self.base_quantum = base_quantum
        self.chunk_mode = chunk_mode
        self.refill_chunks = max(1, refill_chunks)
        # history-driven refill sizing (range mode): the refill quota
        # grows when the observed steal rate is low (well-sized grants —
        # amortize more per global-lock acquire) and shrinks when it is
        # high (grants keep getting clawed back — stop banking them),
        # and a grant near space exhaustion is capped at a fair share of
        # the tail so one group cannot hoard the end of the space and
        # straggle. Off by default at this level (the library contract
        # is plain λ-share refills); DynamicScheduler turns it on.
        self.adaptive_refill = adaptive_refill
        self._refills = 0           # mutated under the global lock only
        self._steals = 0
        self._lock = _TimedLock()
        # refill/steal/reclaim/requeue counters + a lock-wait collector;
        # all off the range-mode fast path (they fire only where the
        # global lock is already taken)
        self.telemetry = telemetry_mod.resolve(telemetry)
        self._tel_counters: Dict[str, object] = {}
        if self.telemetry is not None:
            self.telemetry.registry.add_collector(self._collect)
        # per-space, per-group private ranges (range mode). Weak keys: a
        # finalized epoch's space drops its range table with it, so a
        # long-lived daemon does not accumulate one table per batch.
        self._ranges: "weakref.WeakKeyDictionary[IterationSpace, Dict[str, _GroupRange]]" \
            = weakref.WeakKeyDictionary()
        accels = [g for g in self.groups.values()
                  if g.kind == DeviceKind.ACCEL]
        self._ref: Optional[GroupSpec] = accels[0] if accels else None
        for g in self.groups.values():
            tracker.seed(g.name, g.init_throughput)

    # ------------------------------------------------------------------
    def begin_epoch(self, space: IterationSpace) -> None:
        """Epoch reset: install the next iteration space, keeping group
        membership, the accel reference, and (tracker-held) λ state."""
        with self._lock:
            self.space = space

    # ------------------------------------------------------------------
    def add_group(self, spec: GroupSpec) -> None:
        """Elastic join: the group starts receiving λ-proportional chunks."""
        with self._lock:
            self.groups[spec.name] = spec
            self.tracker.seed(spec.name, spec.init_throughput)
            if spec.kind == DeviceKind.ACCEL and self._ref is None:
                self._ref = spec

    def remove_group(self, name: str) -> None:
        """Elastic leave / failure: stop scheduling to the group. Its
        unconsumed private ranges flow back to their spaces (count
        conservation — same semantics as ``requeue``), so a live
        dispatcher can absorb them."""
        with self._lock:
            self.groups.pop(name, None)
            if self._ref is not None and self._ref.name == name:
                accels = [g for g in self.groups.values()
                          if g.kind == DeviceKind.ACCEL]
                self._ref = accels[0] if accels else None
            for space, ranges in list(self._ranges.items()):
                st = ranges.get(name)
                if st is None:
                    continue
                with st.lock:
                    leftover = st.hi - st.lo
                    st.lo = st.hi
                if leftover > 0:
                    space.put_back(Chunk(0, leftover))
                    if self.telemetry is not None:
                        self._count("part.reclaims")
                        self._count("part.reclaimed_items", leftover)
                        self.telemetry.tracer.instant(
                            "range_reclaim", tid="partitioner",
                            group=name, items=leftover)

    def has_work(self, space: IterationSpace) -> bool:
        """Whether ``space`` still has takeable work: unassigned items or
        (range mode) an unconsumed private range some group could steal
        from. Lock-free racy read — the scheduler uses it only to decide
        where an idle dispatcher goes next, and next_token re-checks
        under the proper locks."""
        if space.remaining > 0:
            return True
        if self.chunk_mode == "paper":
            return False
        ranges = self._ranges.get(space)
        if not ranges:
            return False
        return any(st.hi > st.lo for st in ranges.values())

    def reclaim_space(self, space: IterationSpace) -> int:
        """Epoch cancellation: return *every* group's unconsumed private
        range for ``space`` back to it (count conservation, same semantics
        as ``requeue``/``remove_group``), so the cancelled epoch's
        unfinished tail is visible as ``space.remaining`` — the unit the
        service's requeue accounting works in. Groups keep their ranges in
        every *other* space; a chunk a dispatcher carved out concurrently
        is already out of the range and will simply complete (cooperative
        cancellation is chunk-granular). Returns the reclaimed item
        count."""
        total = 0
        with self._lock:
            ranges = self._ranges.get(space)
            if not ranges:
                return 0
            for name, st in ranges.items():
                with st.lock:
                    leftover = st.hi - st.lo
                    st.lo = st.hi
                if leftover > 0:
                    space.put_back(Chunk(0, leftover))
                    total += leftover
        if total and self.telemetry is not None:
            self._count("part.reclaims")
            self._count("part.reclaimed_items", total)
            self.telemetry.tracer.instant("cancel_reclaim",
                                          tid="partitioner", items=total)
        return total

    # ------------------------------------------------------------------
    def chunk_size_for(self, name: str) -> int:
        g = self.groups[name]
        if g.kind == DeviceKind.ACCEL and g.fixed_chunk:
            size = g.fixed_chunk
        elif self._ref is not None and self._ref.fixed_chunk:
            lam_ref = self.tracker.get(self._ref.name)
            lam = self.tracker.get(name)
            # eq. (4) compares like with like (both previous-interval
            # measurements). While the reference λ is still an unmeasured
            # seed, a *measured* λ here can be 100× the seed (a warm CPU
            # vs. a cold accel) and the ratio would hand this group the
            # rest of the space — hold it to its seed until the
            # reference has a real measurement. Range mode only: the
            # paper path reproduces the original behavior bit-for-bit.
            if self.chunk_mode == "range" \
                    and not self.tracker.measured(self._ref.name):
                lam = self.tracker.seed_of(name)
            size = int(round(self._ref.fixed_chunk * lam
                             / max(lam_ref, 1e-12)))          # eq. (4)
        else:
            # homogeneous fallback: quantum scaled by relative λ
            lams = self.tracker.snapshot()
            mx = max(lams.values()) if lams else 1.0
            size = int(round(self.base_quantum
                             * self.tracker.get(name) / max(mx, 1e-12)))
        size = max(size, g.min_chunk)
        if g.max_chunk:
            size = min(size, g.max_chunk)
        return size

    def next_token(self, name: str,
                   space: Optional[IterationSpace] = None) -> Optional[Token]:
        """Filter₁ body for a device that just became idle. ``space``
        selects the epoch to draw from (defaults to the current one)."""
        g = self.groups.get(name)
        if g is None:
            return None
        if self.chunk_mode == "paper":
            with self._lock:
                if name not in self.groups:
                    return None
                chunk = (space or self.space).take(self.chunk_size_for(name))
                if chunk is None:
                    return None
                return Token(chunk, g.name, g.kind)
        # -- range mode fast path: private arithmetic, no shared lock --
        sp = space if space is not None else self.space
        st = self._range_for(sp, name)
        with st.lock:
            lo = st.lo
            if lo < st.hi:
                n = st.chunk
                if lo + n > st.hi:
                    n = st.hi - lo
                st.lo = lo + n
                return Token(Chunk(lo, lo + n, sp.next_seq()), name, g.kind)
        return self._refill_or_steal(sp, name, st)

    def requeue(self, chunk: Chunk,
                space: Optional[IterationSpace] = None) -> None:
        """Fault tolerance: a failed/lost chunk re-enters its space."""
        with self._lock:
            (space or self.space).put_back(chunk)
        if self.telemetry is not None:
            self._count("part.requeues")
            self._count("part.requeued_items", chunk.size)
            self.telemetry.tracer.instant("chunk_requeue",
                                          tid="partitioner",
                                          items=chunk.size, seq=chunk.seq)

    # -- telemetry plumbing ---------------------------------------------
    def _count(self, name: str, n: float = 1.0) -> None:
        c = self._tel_counters.get(name)
        if c is None:
            c = self._tel_counters[name] = \
                self.telemetry.registry.counter(name)
        c.add(n)

    def _collect(self) -> None:
        """Snapshot-time collector: publish global-lock contention as
        gauges (the exporter thread pulls; the hot path never pushes)."""
        stats = self.contention_stats()
        reg = self.telemetry.registry
        reg.gauge("part.lock_wait_s").set(stats["lock_wait_s"])
        reg.gauge("part.lock_acquires").set(stats["lock_acquires"])

    # -- range machinery (global lock only here) ------------------------
    def _range_for(self, sp: IterationSpace, name: str) -> _GroupRange:
        ranges = self._ranges.get(sp)
        if ranges is not None:
            st = ranges.get(name)
            if st is not None:
                return st
        with self._lock:
            ranges = self._ranges.setdefault(sp, {})
            st = ranges.get(name)
            if st is None:
                st = ranges[name] = _GroupRange()
            return st

    def _refill_or_steal(self, sp: IterationSpace, name: str,
                         st: _GroupRange) -> Optional[Token]:
        """Slow path: the group's range ran dry. Refill it λ-share-sized
        from the unassigned space, or steal from the largest remaining
        range when the space is exhausted."""
        with self._lock:
            g = self.groups.get(name)
            if g is None:
                return None
            with st.lock:
                if st.lo < st.hi:       # raced with another refill/steal
                    n = min(st.chunk, st.hi - st.lo)
                    lo, st.lo = st.lo, st.lo + n
                    return Token(Chunk(lo, lo + n, sp.next_seq()),
                                 name, g.kind)
            chunk = self.chunk_size_for(name)
            stats = self.tracker.stats(name)
            quota = self._refill_quota_locked()
            if stats is None or stats.n == 0:
                # cold start: λ is still the seed, so a multi-chunk grant
                # would bank work on a guess (a slow group could hoard a
                # λ-share range it then crawls through). One chunk, like
                # the paper path, until the first real measurement.
                want = chunk
            else:
                lam = self.tracker.get(name)
                total_lam = sum(self.tracker.get(n_)
                                for n_ in self.groups) or 1.0
                # λ-share of the remaining space, at least one chunk, at
                # most the refill quota in chunks: big enough to amortize
                # the refill, small enough that a mis-sized grant is
                # cheap to steal back
                want = min(quota * chunk,
                           max(chunk, int(sp.remaining * lam / total_lam)))
                if self.adaptive_refill:
                    tail = sp.remaining
                    n_groups = max(1, len(self.groups))
                    if tail <= quota * chunk * n_groups:
                        # near exhaustion: a full λ-share grant here is
                        # tail hoarding (peers finish and must steal it
                        # back one half at a time) — cap at a fair share
                        want = max(chunk, min(want, tail // n_groups))
            c = sp.take(want)
            if c is None:
                c = self._steal_locked(sp, name, chunk)
                if c is None:
                    return None
                self._steals += 1
                if self.telemetry is not None:
                    self._count("part.steals")
                    self._count("part.stolen_items", c.size)
                    self.telemetry.tracer.instant(
                        "range_steal", tid="partitioner",
                        thief=name, items=c.size)
            else:
                self._refills += 1
                if self.telemetry is not None:
                    self._count("part.refills")
                    self._count("part.refill_items", c.size)
            with st.lock:
                st.chunk = chunk
                st.lo, st.hi = c.begin, c.end
                n = min(chunk, st.hi - st.lo)
                lo, st.lo = st.lo, st.lo + n
            return Token(Chunk(lo, lo + n, c.seq), name, g.kind)

    def _refill_quota_locked(self, min_total: int = 8,
                             low: float = 0.05, high: float = 0.25) -> int:
        """Effective refill size in chunks. Static (``refill_chunks``)
        unless adaptive: after ``min_total`` refill/steal events the
        observed steal rate steers it — ≤ ``low`` doubles the quota
        (grants are landing where the work is; amortize more per
        global-lock acquire), ≥ ``high`` halves it (grants keep getting
        stolen back; stop banking work on stale λ)."""
        if not self.adaptive_refill:
            return self.refill_chunks
        total = self._refills + self._steals
        if total >= min_total:
            rate = self._steals / total
            if rate >= high:
                return max(1, self.refill_chunks // 2)
            if rate <= low:
                return self.refill_chunks * 2
        return self.refill_chunks

    def refill_stats(self) -> Dict[str, float]:
        """Refill/steal event counts + the current effective refill quota
        (chunks) — the adaptive-refill feedback state, for benchmarks and
        tests. Read under the global lock (same consistency contract as
        ``contention_stats``)."""
        with self._lock._lock:
            return {"refills": float(self._refills),
                    "steals": float(self._steals),
                    "refill_quota": float(self._refill_quota_locked())}

    def _steal_locked(self, sp: IterationSpace, name: str,
                      chunk: int) -> Optional[Chunk]:
        """Take the tail half (≥ one chunk) of the largest remaining range
        of another group — exact load balancing at the end of the space,
        where a λ-share grant to a slow group would otherwise straggle."""
        ranges = self._ranges.get(sp)
        if not ranges:
            return None
        victims = sorted(
            ((st.remaining, n) for n, st in ranges.items() if n != name),
            reverse=True)
        for _, victim_name in victims:
            victim = ranges[victim_name]
            with victim.lock:
                avail = victim.hi - victim.lo
                if avail <= 0:
                    continue
                take = avail if avail <= chunk else max(chunk, avail // 2)
                victim.hi -= take
                return Chunk(victim.hi, victim.hi + take, sp.next_seq())
        return None

    # -- introspection ---------------------------------------------------
    def contention_stats(self) -> Dict[str, float]:
        """Global-lock wait time + acquire count. In paper mode every
        token grant goes through it; in range mode only refills, steals,
        requeues, and membership changes do. The pair is read under the
        raw lock so the two fields are from the same acquire (no torn
        snapshot), without the timed wrapper charging the read itself to
        ``wait_s``."""
        with self._lock._lock:
            return {"lock_wait_s": self._lock.wait_s,
                    "lock_acquires": float(self._lock.acquires)}
