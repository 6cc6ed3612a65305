"""Tenant-consistent-hash routing with bounded loads.

Placement is consistent hashing with bounded loads (Mirrokni et al.): a
tenant's jobs walk the vnode ring clockwise from ``hash(tenant)`` and
land on the first runtime whose current load, plus the new job, stays
within ``bound ×`` its *capacity share* of the total — so a hot tenant
sticks to its home runtime (cache/journal locality, stable DWRR shard)
until that runtime is genuinely over-loaded relative to the fleet, then
spills along its own deterministic ring walk. Capacity shares come from
gossiped per-runtime λ-aggregates (stale-derated by the GossipBus), so a
slow or silent runtime attracts proportionally less work without any
explicit drain command.

Properties the tests pin down:

  * bounded balance — no runtime's load exceeds ``bound`` × its capacity
    share of (total+1), up to the one-job granularity;
  * minimal remapping — adding/removing a runtime moves only the keys
    whose ring walk hits the changed vnodes (≈ K/N expected), and on a
    join every moved key moves TO the joiner, never between survivors;
  * determinism — identical ring + loads + capacities place identically
    (no RNG anywhere), so N front-ends sharing gossip state agree.
"""
from __future__ import annotations

import bisect
import hashlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple


def _hash(key: str) -> int:
    """Stable 64-bit point on the ring (process-seed-independent, unlike
    builtin hash())."""
    return int.from_bytes(
        hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(),
        "big")


class Router:
    def __init__(self, runtimes: Sequence[str] = (), vnodes: int = 64,
                 bound: float = 1.25):
        if not bound > 1.0:
            raise ValueError(f"bound must be > 1, got {bound}")
        self.vnodes = max(1, int(vnodes))
        self.bound = float(bound)
        self._lock = threading.Lock()
        self._points: List[Tuple[int, str]] = []   # sorted (hash, rid)
        self._capacity: Dict[str, float] = {}
        for rid in runtimes:
            self.add_runtime(rid)

    # -- membership ----------------------------------------------------
    def add_runtime(self, rid: str, capacity: float = 1.0) -> None:
        with self._lock:
            if rid in self._capacity:
                return
            self._capacity[rid] = max(0.0, float(capacity))
            for i in range(self.vnodes):
                bisect.insort(self._points, (_hash(f"{rid}#{i}"), rid))

    def remove_runtime(self, rid: str) -> None:
        with self._lock:
            if self._capacity.pop(rid, None) is None:
                return
            self._points = [p for p in self._points if p[1] != rid]

    def runtimes(self) -> List[str]:
        with self._lock:
            return sorted(self._capacity)

    # -- capacity (gossip-fed) -----------------------------------------
    def set_capacity(self, rid: str, capacity: float) -> None:
        with self._lock:
            if rid in self._capacity:
                self._capacity[rid] = max(0.0, float(capacity))

    def capacity_share(self, rid: str) -> float:
        with self._lock:
            return self._share_locked(rid)

    def _share_locked(self, rid: str) -> float:
        total = sum(self._capacity.values())
        if total <= 0.0:                   # no gossip yet: equal shares
            return 1.0 / max(1, len(self._capacity))
        return self._capacity.get(rid, 0.0) / total

    # -- placement -----------------------------------------------------
    def place(self, key: str, loads: Optional[Dict[str, float]] = None,
              weight: float = 1.0) -> Optional[str]:
        """Place one unit of ``weight`` for ``key`` (the tenant). The
        ring walk from ``hash(key)`` skips runtimes whose load would
        exceed ``bound × share × (total + weight)``; the per-candidate
        ``max(weight, …)`` floor guarantees progress (the first candidate
        can always take the first unit). Returns None with no members."""
        with self._lock:
            if not self._points:
                return None
            loads = loads or {}
            total = sum(loads.values()) + weight
            start = bisect.bisect_left(self._points, (_hash(key), ""))
            n = len(self._points)
            seen = set()
            fallback, fallback_head = None, 0.0
            for off in range(n):
                rid = self._points[(start + off) % n][1]
                if rid in seen:
                    continue
                seen.add(rid)
                limit = max(weight,
                            self.bound * self._share_locked(rid) * total)
                load = loads.get(rid, 0.0)
                if load + weight <= limit + 1e-9:
                    return rid
                # headroom-relative fallback if every runtime is over its
                # bound (can only happen when the caller's load map
                # includes weight the ring never placed)
                head = limit - load
                if fallback is None or head > fallback_head:
                    fallback, fallback_head = rid, head
            return fallback

    def place_many(self, keys: Sequence[str],
                   loads: Optional[Dict[str, float]] = None,
                   weight: float = 1.0) -> Dict[str, str]:
        """Place a batch, threading the load increments through — the
        water-filling the property tests exercise."""
        loads = dict(loads or {})
        out: Dict[str, str] = {}
        for key in keys:
            rid = self.place(key, loads, weight=weight)
            if rid is None:
                break
            out[key] = rid
            loads[rid] = loads.get(rid, 0.0) + weight
        return out
