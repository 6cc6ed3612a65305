"""Heartbeat gossip between federated runtimes, with stale derating.

Each runtime periodically publishes a ``Heartbeat`` — its λ-aggregate
useful capacity (AdmissionController.capacity_items_s, i.e. the sharded
ThroughputTracker EWMAs derated by §3.3 overhead fractions and straggler
reports), queue depth/backlog, queue-delay quantiles, and per-tenant
unfinished-work / attributed-joule counts. The ``GossipBus`` is the
in-process stand-in for the gossip mesh: publish replaces the runtime's
latest view, readers aggregate across views.

Staleness is first-class: a runtime that stops heartbeating (crashed,
wedged, partitioned) must stop attracting work *before* anyone declares
it dead. ``effective_capacity`` derates a runtime's advertised capacity
linearly with heartbeat age past ``stale_after_s`` — full trust inside
the window, decaying to a floor by ``2 × stale_after_s`` — so the router
sheds load off a silent runtime on the same gradient a straggler derate
uses, rather than a binary alive/dead cliff.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class Heartbeat:
    runtime_id: str
    ts: float                                  # bus-clock publish stamp
    capacity_items_s: float = 0.0
    queue_depth: int = 0
    backlog_items: int = 0
    delay_p50_s: float = 0.0
    delay_p95_s: float = 0.0
    done: int = 0
    failed: int = 0
    # per-tenant views for global quota / energy enforcement
    unfinished_jobs: Dict[str, int] = field(default_factory=dict)
    energy_j: Dict[str, float] = field(default_factory=dict)


class GossipBus:
    #: capacity trust floor for an arbitrarily stale heartbeat — nonzero
    #: so a runtime recovering from a GC-length stall still drains its
    #: routed backlog instead of being starved into a second incident
    STALE_FLOOR = 0.1

    def __init__(self, stale_after_s: float = 2.0, clock=None):
        self.stale_after_s = float(stale_after_s)
        self.clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        self._latest: Dict[str, Heartbeat] = {}
        self.published = 0

    # -- write side ----------------------------------------------------
    def publish(self, hb: Heartbeat) -> None:
        with self._lock:
            self._latest[hb.runtime_id] = hb
            self.published += 1

    def drop(self, runtime_id: str) -> None:
        """Forget a runtime (killed / removed) — its heartbeats must not
        keep counting toward global quota or capacity."""
        with self._lock:
            self._latest.pop(runtime_id, None)

    # -- read side -----------------------------------------------------
    def view(self) -> Dict[str, Heartbeat]:
        with self._lock:
            return dict(self._latest)

    def get(self, runtime_id: str) -> Optional[Heartbeat]:
        with self._lock:
            return self._latest.get(runtime_id)

    def stale_factor(self, hb: Heartbeat,
                     now: Optional[float] = None) -> float:
        age = (self.clock() if now is None else now) - hb.ts
        if age <= self.stale_after_s:
            return 1.0
        over = (age - self.stale_after_s) / max(self.stale_after_s, 1e-9)
        return max(self.STALE_FLOOR, 1.0 - over)

    def effective_capacity(self, runtime_id: str,
                           now: Optional[float] = None) -> float:
        """Advertised capacity × stale derate (0.0 for an unknown id)."""
        hb = self.get(runtime_id)
        if hb is None:
            return 0.0
        return hb.capacity_items_s * self.stale_factor(hb, now)

    # -- fleet aggregates ----------------------------------------------
    def unfinished(self, tenant: str) -> int:
        """Fleet-wide unfinished jobs for one tenant (global quota
        numerator)."""
        with self._lock:
            return sum(hb.unfinished_jobs.get(tenant, 0)
                       for hb in self._latest.values())

    def energy(self, tenant: str) -> float:
        """Fleet-wide attributed joules for one tenant (global energy
        budget numerator)."""
        with self._lock:
            return sum(hb.energy_j.get(tenant, 0.0)
                       for hb in self._latest.values())

    def tenants(self) -> set:
        with self._lock:
            out = set()
            for hb in self._latest.values():
                out.update(hb.unfinished_jobs)
                out.update(hb.energy_j)
            return out
