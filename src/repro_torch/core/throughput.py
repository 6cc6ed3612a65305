"""Per-group effective-throughput tracking — the paper's eqs (1)–(2).

λ_G(tG_i) = G / T(tG_i),  λ_C(tC_i) = C(tC_i) / T(tC_i)

The paper uses the previous interval's throughput directly (eq. 3/4). At
fleet scale single-interval estimates are noisy and a slowing group must be
detected quickly (straggler mitigation), so we keep an EWMA with the raw
last-interval value available; ``alpha=1.0`` reproduces the paper exactly.

Sharded hot path (the default ``ThroughputTracker``): ``update`` /
``update_many`` run on every chunk completion, on every dispatcher thread
— the last shared lock on the completion path before this design. The
tracker now keeps one *cell* per (group, updating thread), same
bank-on-hot-path pattern as ``repro_torch.telemetry``'s metric cells: an update
is plain arithmetic on the calling thread's own cell plus ONE atomic
reference store, no shared lock. Readers (``get`` / ``stats`` /
``snapshot`` — refill sizing, admission capacity, straggler observation;
all orders of magnitude rarer than updates) merge the cells: counts and
totals are summed, and the EWMA/last pair comes from the cell holding the
globally newest update (a monotonically increasing write-sequence stamped
into each cell's state tuple — the same merge-by-latest-seq trick the
telemetry gauges use).

Exactness: the scheduler's invariant is single-writer-per-group (a
group's records are fed only by its own dispatcher — stolen ranges
execute under the *thief's* group name), so each group normally has
exactly one live cell and the merged view is bit-identical to the old
single-lock tracker (property-tested in tests/test_policy.py). When a
group's writer thread changes (scheduler rebuild, elastic re-join), the
fresh cell seeds its EWMA chain from the merged view at creation time, so
the EWMA is continuous across the handoff; with ``alpha=1.0`` (paper
mode) the merged EWMA equals the newest record's λ under *any*
interleaving, single-writer or not.

The registration lock (first touch of a group by a thread) is a
``TimedLock``; ``contention_stats()`` exposes its wait time so the
dispatch benchmark can assert the completion path's shared-lock wait is
~0. ``LockedThroughputTracker`` keeps the original single-lock
implementation as the benchmark baseline and the property-test oracle.
"""
from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, replace
from typing import Dict, List, Optional

from repro_torch.core.locks import TimedLock
from repro_torch.core.types import ChunkRecord

#: global write sequence for merge-by-latest (shared across trackers is
#: fine — only the relative order of one tracker's cells matters)
_WRITE_SEQ = itertools.count(1)

#: cell state tuple layout: (ewma, last, n, total_items, total_time, seq)
_EMPTY = (0.0, 0.0, 0, 0, 0.0, 0)


@dataclass
class GroupStats:
    ewma: float = 0.0
    last: float = 0.0
    n: int = 0
    total_items: int = 0
    total_time: float = 0.0

    @property
    def lifetime(self) -> float:
        return self.total_items / self.total_time if self.total_time else 0.0


class _Cell:
    """One (group, thread) shard. ``data`` is the full state tuple,
    replaced with a single reference store per update — readers load it
    with one reference read, so a merge never sees a torn
    items/time/EWMA combination (the atomicity the old tracker bought
    with its lock). ``chain`` seeds the EWMA continuation when this cell
    takes over a group from a previous writer thread."""

    __slots__ = ("data", "chain")

    def __init__(self, chain: Optional[float] = None):
        self.data = _EMPTY
        self.chain = chain


class ThroughputTracker:
    def __init__(self, alpha: float = 1.0):
        """alpha=1.0 -> paper-faithful (previous interval only)."""
        assert 0.0 < alpha <= 1.0
        self.alpha = alpha
        self._seed: Dict[str, float] = {}
        # group -> every cell ever registered for it (cells of retired
        # threads keep contributing their totals to the merged view)
        self._cells: Dict[str, List[_Cell]] = {}
        self._local = threading.local()
        # registration/read lock — NOT on the update path (a thread
        # touches it once per group it ever updates, then never again)
        self._lock = TimedLock()

    # -- hot path (dispatcher threads) ---------------------------------
    def _cell(self, group: str) -> _Cell:
        try:
            mine = self._local.cells
        except AttributeError:
            mine = self._local.cells = {}
        c = mine.get(group)
        if c is None:
            with self._lock:
                merged = self._merged(group)
                chain = merged.ewma if merged is not None and merged.n \
                    else None
                c = _Cell(chain=chain)
                self._cells.setdefault(group, []).append(c)
            mine[group] = c
        return c

    def update(self, rec: ChunkRecord) -> float:
        lam = rec.throughput
        c = self._cell(rec.token.group)
        ewma, _, n, items, t, _ = c.data
        if n == 0:
            ewma = lam if c.chain is None else \
                self.alpha * lam + (1 - self.alpha) * c.chain
        else:
            ewma = self.alpha * lam + (1 - self.alpha) * ewma
        c.data = (ewma, lam, n + 1, items + rec.token.chunk.size,
                  t + max(rec.device_time, 1e-12), next(_WRITE_SEQ))
        return ewma

    def update_many(self, recs) -> None:
        """Batched update for a whole completion batch: the loop runs on
        thread-local values and publishes ONE state tuple at the end."""
        it = iter(recs)
        first = next(it, None)
        if first is None:
            return
        group = first.token.group
        c = self._cell(group)
        ewma, last, n, items, t, _ = c.data
        a = self.alpha
        for rec in itertools.chain((first,), it):
            g = rec.token.group
            if g != group:              # mixed batch: flush, switch cells
                c.data = (ewma, last, n, items, t, next(_WRITE_SEQ))
                group, c = g, self._cell(g)
                ewma, last, n, items, t, _ = c.data
            lam = rec.throughput
            if n == 0:
                ewma = lam if c.chain is None else \
                    a * lam + (1 - a) * c.chain
            else:
                ewma = a * lam + (1 - a) * ewma
            last = lam
            n += 1
            items += rec.token.chunk.size
            t += max(rec.device_time, 1e-12)
        c.data = (ewma, last, n, items, t, next(_WRITE_SEQ))

    # -- seeds ---------------------------------------------------------
    def seed(self, group: str, lam: float) -> None:
        with self._lock:
            self._seed[group] = lam

    def seed_of(self, group: str) -> float:
        return self._seed.get(group, 1.0)   # GIL-atomic dict read

    # -- merged reads (lock-free) --------------------------------------
    def _merged(self, group: str) -> Optional[GroupStats]:
        """Merge the group's cells WITHOUT the registration lock: the
        cell list only ever grows (list.append is GIL-atomic; a reader
        iterating concurrently at worst misses a cell registered after
        the read began — the same staleness any lock-free snapshot has),
        and each cell's state is one atomic tuple load. ``get`` rides the
        dispatch hot path (chunk sizing on every token grant), so reads
        must be as lock-free as updates."""
        cells = self._cells.get(group)
        if not cells:
            return None
        out = GroupStats()
        best_seq = 0
        for c in cells:
            ewma, last, n, items, t, seq = c.data   # one atomic load
            out.n += n
            out.total_items += items
            out.total_time += t
            if seq > best_seq:                      # newest writer wins
                best_seq = seq
                out.ewma, out.last = ewma, last
        return out

    def get(self, group: str) -> float:
        st = self._merged(group)
        if st is not None and st.n:
            return st.ewma
        return self._seed.get(group, 1.0)

    def measured(self, group: str) -> bool:
        """Whether ``get`` returns a real measurement (vs. a seed)."""
        st = self._merged(group)
        return bool(st is not None and st.n)

    def stats(self, group: str) -> Optional[GroupStats]:
        """Merged view of the group's stats — a fresh object, so callers
        can never mutate tracker state through it."""
        return self._merged(group)

    def snapshot(self) -> Dict[str, float]:
        out = dict(self._seed)              # GIL-atomic dict copy
        for g in list(self._cells):         # GIL-atomic key list
            st = self._merged(g)
            if st is not None and st.n:
                out[g] = st.ewma
        return out

    def contention_stats(self) -> Dict[str, float]:
        """Registration/read-lock wait + acquire count. The completion
        path touches this lock only on a thread's FIRST update for a
        group — steady-state updates never acquire it, which is what the
        dispatch benchmark asserts."""
        return self._lock.stats()


class LockedThroughputTracker:
    """The original single-lock tracker: every update serializes on one
    shared lock. Kept as the dispatch-overhead benchmark baseline and as
    the oracle for the sharded tracker's merge-equivalence property test
    (tests/test_policy.py). Same API as ``ThroughputTracker``."""

    def __init__(self, alpha: float = 1.0):
        assert 0.0 < alpha <= 1.0
        self.alpha = alpha
        self._stats: Dict[str, GroupStats] = {}
        self._seed: Dict[str, float] = {}
        self._lock = TimedLock()

    def seed(self, group: str, lam: float) -> None:
        with self._lock:
            self._seed[group] = lam

    def update(self, rec: ChunkRecord) -> float:
        with self._lock:
            return self._update_locked(rec)

    def update_many(self, recs) -> None:
        with self._lock:
            for rec in recs:
                self._update_locked(rec)

    def _update_locked(self, rec: ChunkRecord) -> float:
        lam = rec.throughput
        st = self._stats.setdefault(rec.token.group, GroupStats())
        st.last = lam
        st.ewma = lam if st.n == 0 else \
            self.alpha * lam + (1 - self.alpha) * st.ewma
        st.n += 1
        st.total_items += rec.token.chunk.size
        st.total_time += max(rec.device_time, 1e-12)
        return st.ewma

    def get(self, group: str) -> float:
        with self._lock:
            st = self._stats.get(group)
            if st and st.n:
                return st.ewma
            return self._seed.get(group, 1.0)

    def measured(self, group: str) -> bool:
        with self._lock:
            st = self._stats.get(group)
            return bool(st is not None and st.n)

    def seed_of(self, group: str) -> float:
        with self._lock:
            return self._seed.get(group, 1.0)

    def stats(self, group: str) -> Optional[GroupStats]:
        with self._lock:
            st = self._stats.get(group)
            return None if st is None else replace(st)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            out = dict(self._seed)
            out.update({g: s.ewma for g, s in self._stats.items() if s.n})
            return out

    def contention_stats(self) -> Dict[str, float]:
        """Shared-lock wait + acquires — every update pays it here."""
        return self._lock.stats()
