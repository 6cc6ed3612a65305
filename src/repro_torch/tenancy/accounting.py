"""Per-tenant accounting: busy-time, joules, and EDP attribution.

The scheduler runtime conserves iteration *count*, not identity — a
drained batch's chunks are not tenant-tagged. What is known exactly is
which jobs composed the batch and how many items each tenant contributed,
so a batch's busy seconds, wall time, and energy are attributed to
tenants proportionally to their item share (the same proportionality the
paper's eq. (4) uses to split time between devices). Attribution happens
at batch finalization, which keeps the accountant O(tenants) in memory on
a long-lived daemon.

Per-tenant EDP uses the tenant's *attributed* energy and wall time
(E_t · T_t, Gonzales & Horowitz per tenant): the number a per-tenant
energy bill / efficiency SLO would be written against.

Attributed joules are *marginal* (active-power × attributed busy time):
on the double-buffered drain consecutive batches overlap in wall-clock,
so charging each batch's idle/base energy over its own window would bill
the same idle seconds to several batches — the runtime-level idle/base
energy remains a platform cost, visible in EnergyModel.energy reports,
not in per-tenant bills. Wall time gets the same de-overlap treatment:
when the caller supplies the batch's monotonic window, only the part
past the previously accounted window is attributed, so Σ wall_s across
tenants tracks real elapsed pipeline time, not pipeline_depth× it. Only *completed* batches are attributed: a
failed batch's jobs are requeued and re-run in full, so attributing the
failed attempt too would double-count the tenant's items (and overstate
its fairness share); the energy a failed attempt burned is waste charged
to no tenant.

Soft energy budgets: ``derate_weights()`` maps each over-budget tenant to
``budget/spent`` (floored at ``derate_floor``) — the sharded queue applies
it as a multiplicative weight derate, so an energy hog keeps running but
at a shrunken share instead of being cut off (enforcement at the
arbitration layer, as in Dev et al.'s power-budgeted CPU-GPU chips).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, TYPE_CHECKING

if TYPE_CHECKING:                            # pragma: no cover
    from repro_torch.core.energy import EnergyModel
    from repro_torch.core.scheduler import ScheduleResult
    from repro_torch.queue.job import Job


@dataclass
class TenantUsage:
    """Cumulative attributed usage for one tenant. ``queue_delays`` is a
    ring of the most recent DELAY_CAP samples (bounded memory on a
    daemon, but the percentiles stay live instead of freezing at the
    first DELAY_CAP jobs)."""
    items: int = 0
    busy_s: float = 0.0                      # attributed device-busy time
    wall_s: float = 0.0                      # attributed batch wall time
    energy_j: float = 0.0
    batches: int = 0
    queue_delays: List[float] = field(default_factory=list)
    delay_pos: int = 0                       # ring write cursor

    @property
    def edp(self) -> float:
        return self.energy_j * self.wall_s

    def as_dict(self) -> Dict:
        return {"items": self.items, "busy_s": self.busy_s,
                "wall_s": self.wall_s, "energy_j": self.energy_j,
                "edp": self.edp, "batches": self.batches}


class TenantAccountant:
    DELAY_CAP = 100_000                      # bounded memory on a daemon

    def __init__(self, registry=None,
                 energy_model: Optional["EnergyModel"] = None,
                 derate_floor: float = 0.1):
        self.registry = registry
        self.energy_model = energy_model
        self.derate_floor = derate_floor
        self._usage: Dict[str, TenantUsage] = {}
        self._window_end = float("-inf")     # monotonic de-overlap cursor
        # derates computed OUTSIDE this accountant (the federation tier's
        # global energy budgets); merged into derate_weights() by min()
        self._external: Dict[str, float] = {}
        self._lock = threading.Lock()

    def usage(self, tenant: str) -> TenantUsage:
        with self._lock:
            u = self._usage.get(tenant)
            if u is None:
                u = self._usage[tenant] = TenantUsage()
            return u

    # -- attribution ----------------------------------------------------
    def record_batch(self, jobs: Iterable["Job"],
                     result: Optional["ScheduleResult"],
                     window: Optional[tuple] = None,
                     count_items: bool = True) -> Dict[str, float]:
        """Attribute one finalized batch to its tenants by item share.

        ``window`` is the batch's monotonic ``(submitted_at, finished_at)``
        span; when given, only the part past the previously accounted
        window counts as wall time (overlapping pipelined batches must
        not each bill the full span). Returns the share map; each
        ChunkRecord in the batch gets the map stamped into
        ``meta["tenant_shares"]`` so downstream consumers of the record
        stream (ledgers, traces) can re-split per-chunk numbers without
        re-deriving batch composition.

        ``count_items=False`` charges busy time / wall / joules but NOT
        item counts: a *cancelled* (deadline-preempted) batch consumed
        real device time that no retry gives back, yet its unfinished
        jobs requeue and the completing attempt will charge the items —
        charging them here too would double-count the tenant's share.
        """
        items: Dict[str, int] = {}
        for j in jobs:
            items[j.tenant] = items.get(j.tenant, 0) + j.items
        total = sum(items.values())
        if total <= 0 or result is None:
            return {}
        shares = {t: n / total for t, n in items.items()}
        busy = result.busy_seconds()
        busy_total = sum(busy.values())
        energy_total = self.energy_model.busy_energy_j(busy) \
            if self.energy_model is not None else 0.0
        for rec in result.records:
            # independent copy per record: a consumer mutating one
            # record's stamp must not corrupt its batch-mates'
            rec.meta["tenant_shares"] = dict(shares)
        with self._lock:
            wall = result.total_time
            if window is not None:
                start, end = window
                wall = min(wall, max(0.0, end - max(start,
                                                    self._window_end)))
                self._window_end = max(self._window_end, end)
            for t, share in shares.items():
                u = self._usage.setdefault(t, TenantUsage())
                if count_items:
                    u.items += items[t]
                u.busy_s += share * busy_total
                u.wall_s += share * wall
                u.energy_j += share * energy_total
                u.batches += 1
        return dict(shares)

    def record_queue_delay(self, tenant: str, delay_s: float) -> None:
        with self._lock:
            u = self._usage.setdefault(tenant, TenantUsage())
            if len(u.queue_delays) < self.DELAY_CAP:
                u.queue_delays.append(delay_s)
            else:                            # overwrite oldest (ring)
                u.queue_delays[u.delay_pos % self.DELAY_CAP] = delay_s
            u.delay_pos += 1

    # -- soft energy budgets --------------------------------------------
    def set_external_derates(self, factors: Dict[str, float]) -> None:
        """Install weight derates computed by an outer enforcement tier
        (federation: a tenant's *fleet-wide* joules vs. its budget).
        Replaces the previous external map; ``derate_weights()`` merges
        by min(), so whichever enforcement is tighter — local attribution
        or the global aggregate — wins."""
        with self._lock:
            self._external = {
                t: min(1.0, max(self.derate_floor, float(f)))
                for t, f in factors.items()}

    def derate_weights(self) -> Dict[str, float]:
        """Weight factors for tenants over their soft energy budget:
        ``budget/spent`` clamped to [derate_floor, 1]; in-budget tenants
        are omitted (full weight). External (federation-global) derates
        merge in by min()."""
        out: Dict[str, float] = {}
        with self._lock:
            external = dict(self._external)
            if self.registry is not None:
                for t, u in self._usage.items():
                    budget = self.registry.get(t).energy_budget_j
                    if budget is None or u.energy_j <= budget:
                        continue
                    out[t] = max(self.derate_floor, budget / u.energy_j)
        for t, f in external.items():
            out[t] = min(out.get(t, 1.0), f)
        return out

    # -- reporting ------------------------------------------------------
    def snapshot(self) -> Dict[str, Dict]:
        from repro_torch.queue.service import percentiles
        with self._lock:
            out = {}
            for t, u in sorted(self._usage.items()):
                d = u.as_dict()
                d["queue_delay_s"] = percentiles(u.queue_delays)
                out[t] = d
            return out
