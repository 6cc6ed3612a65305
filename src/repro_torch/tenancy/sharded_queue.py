"""ShardedQueueManager: one QueueManager shard per tenant, DWRR drain.

The tenant-blind QueueManager drains strict (priority, FIFO) order, so one
tenant's burst inflates every other tenant's queue delay. This manager
keeps the QueueManager surface (``put/pop/cancel/mark_running/
mark_finished/requeue/depth/backlog_items/...``) but shards jobs by
``job.tenant`` and interleaves ``pop()`` across tenants with
deficit-weighted round robin (DWRR, Shreedhar & Varghese):

  * each tenant carries a deficit counter (in job *items* — the unit the
    capacity model and the scheduler's iteration space both use);
  * on a tenant's turn its deficit grows by ``quantum × effective_weight``
    and its head job is served while the deficit covers the job's items;
  * a tenant whose shard empties leaves the round with its deficit reset
    (classic DWRR — an idle tenant banks no credit), so drained-work share
    converges to weight share among *backlogged* tenants and an
    underloaded tenant is never blocked by another tenant's backlog
    (work conservation: the rotation only ever skips empty or
    quota-capped shards);
  * burst credits: a tenant whose spec carries ``burst_quantum`` keeps up
    to that many items of deficit when its shard empties (bounded
    carry-over, a DWRR/token-bucket hybrid) so a spiky interactive tenant
    does not re-pay the ramp-up rounds on every burst; the default 0
    keeps the classic reset.

``pop_many(max_n)`` forms a whole batch under ONE lock acquisition (the
per-pop DWRR scan repeats while the lock is held, so deficits are
charged per item and fairness shares are identical to ``max_n`` single
pops) — which is what JobService uses to build its scheduler batches
without re-taking the shard lock per job.

Within a shard, the tenant's own priority/FIFO order is untouched.

Quota isolation: a tenant at its ``max_inflight`` (jobs popped but not yet
finished) is skipped by the drain until ``mark_finished`` frees a slot —
its backlog waits without consuming anyone else's turn.

Energy-budget derating: ``set_weight_derates`` scales effective weights by
the accounting layer's soft-budget factors, so a tenant burning past its
joule budget keeps running but at a derated share.

Single-tenant equivalence: with every job on the default tenant there is
one shard and DWRR degenerates to the shard's own heap order — identical
behavior to the single ``QueueManager``.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional

from repro_torch import telemetry as telemetry_mod
from repro_torch.queue.job import Job, JobState
from repro_torch.queue.manager import QueueManager, drain_with_deadline


class ShardedQueueManager:
    def __init__(self, registry=None, quantum: int = 64, telemetry=None):
        # ``registry`` is duck-typed (TenantRegistry: .get(name).weight /
        # .max_inflight); None means every tenant weighs 1 and has no quota
        self.registry = registry
        self.quantum = max(1, int(quantum))
        self._shards: Dict[str, QueueManager] = {}
        self._order: List[str] = []          # rotation order (first-seen)
        self._cursor = 0
        self._replenished = False            # current turn already credited
        self._deficit: Dict[str, float] = {}
        # popped-but-not-finished job ids (the quota denominator); ids,
        # not a counter, so cancel() of a popped-but-unbound job can
        # release its slot instead of leaking it
        self._popped: Dict[str, set] = {}
        self._derate: Dict[str, float] = {}      # energy-budget factors
        self._lock = threading.RLock()
        self._not_empty = threading.Condition(self._lock)
        # arrival listeners (JobService drain wakeup) — fired after
        # put/requeue, outside the manager lock; see QueueManager
        self._listeners: List = []
        # metrics: DWRR pick counters per tenant on the drain path, plus a
        # collector publishing per-tenant depth/backlog gauges at snapshot
        # time (pull, not push — depth reads never ride the hot path)
        self.telemetry = telemetry_mod.resolve(telemetry)
        self._tel: Dict[tuple, object] = {}
        if self.telemetry is not None:
            self.telemetry.registry.add_collector(self._collect)

    # -- telemetry plumbing ---------------------------------------------
    def _tel_pop(self, tenant: str, items: int) -> None:
        key = ("pop", tenant)
        c = self._tel.get(key)
        if c is None:
            reg = self.telemetry.registry
            c = self._tel[key] = (
                reg.counter("queue.dwrr_pops", tenant=tenant),
                reg.counter("queue.dwrr_items", tenant=tenant))
        c[0].add(1)
        c[1].add(items)

    def _collect(self) -> None:
        reg = self.telemetry.registry
        with self._lock:
            rows = [(t, self._shards[t].depth(),
                     self._shards[t].backlog_items(),
                     len(self._popped.get(t, ())))
                    for t in self._order]
        for tenant, depth, backlog, outstanding in rows:
            reg.gauge("queue.depth", tenant=tenant).set(depth)
            reg.gauge("queue.backlog_items", tenant=tenant).set(backlog)
            reg.gauge("queue.outstanding", tenant=tenant).set(outstanding)

    # -- tenant plumbing ------------------------------------------------
    def _shard(self, tenant: str) -> QueueManager:
        shard = self._shards.get(tenant)
        if shard is None:
            shard = self._shards[tenant] = QueueManager()
            self._order.append(tenant)
            self._deficit[tenant] = 0.0
            self._popped.setdefault(tenant, set())
        return shard

    def _spec(self, tenant: str):
        return self.registry.get(tenant) if self.registry is not None \
            else None

    def _weight(self, tenant: str) -> float:
        spec = self._spec(tenant)
        w = spec.weight if spec is not None else 1.0
        return max(1e-9, w * self._derate.get(tenant, 1.0))

    def effective_weight(self, tenant: str) -> float:
        """The weight the DWRR drain actually uses (spec weight × energy
        derate, floored) — the admission gate's fair-share capacity model
        asks this instead of re-deriving the policy."""
        with self._lock:
            return self._weight(tenant)

    def _under_quota(self, tenant: str) -> bool:
        spec = self._spec(tenant)
        if spec is None or spec.max_inflight is None:
            return True
        return len(self._popped.get(tenant, ())) < spec.max_inflight

    def set_weight_derates(self, factors: Dict[str, float]) -> None:
        """Replace the energy-budget derate map (factor ∈ (0, 1]); tenants
        not present recover full weight."""
        with self._lock:
            self._derate = {t: min(1.0, max(1e-6, f))
                            for t, f in factors.items()}

    def weight_derate(self, tenant: str) -> float:
        with self._lock:
            return self._derate.get(tenant, 1.0)

    def tenants(self) -> List[str]:
        with self._lock:
            return list(self._order)

    # -- admission side -------------------------------------------------
    def add_listener(self, fn) -> None:
        """Register ``fn()`` to run after each job arrival (put/requeue)."""
        with self._lock:
            self._listeners.append(fn)

    def _notify_listeners(self) -> None:
        with self._lock:
            listeners = list(self._listeners)
        for fn in listeners:
            fn()

    def put(self, job: Job) -> None:
        with self._not_empty:
            self._shard(job.tenant).put(job)
            self._not_empty.notify()
        self._notify_listeners()

    def cancel(self, job_id: str) -> bool:
        with self._not_empty:
            for tenant, shard in self._shards.items():
                if shard.cancel(job_id):
                    # a job cancelled in the popped-but-unbound window
                    # releases its quota slot (mark_finished will never
                    # run for it) and may unblock a capped shard
                    self._popped[tenant].discard(job_id)
                    self._not_empty.notify()
                    return True
            return False

    # -- scheduler side: the DWRR drain ---------------------------------
    def pop(self, timeout: Optional[float] = None) -> Optional[Job]:
        """Next job in deficit-weighted-round-robin tenant order (priority
        order within the tenant); same blocking contract as
        QueueManager.pop (``timeout=None`` → non-blocking). The wait is
        deadline-based: puts to a quota-capped shard notify without
        making anything eligible, and each such spurious wake-up must
        consume the remaining budget, not restart it — otherwise steady
        traffic to a capped shard pins the caller in pop() forever."""
        with self._not_empty:
            job = self._pop_locked()
            if job is not None or not timeout:
                return job
            deadline = time.monotonic() + timeout
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._not_empty.wait(remaining):
                    return self._pop_locked()
                job = self._pop_locked()
                if job is not None:
                    return job

    def pop_many(self, max_n: int,
                 timeout: Optional[float] = None) -> List[Job]:
        """Up to ``max_n`` jobs under ONE lock acquisition — the per-pop
        DWRR scan repeats with the lock held, so deficits are charged
        per item and drained shares match ``max_n`` single pops exactly.
        Same blocking contract as ``pop``; returns as soon as at least
        one job is eligible."""
        with self._not_empty:
            return drain_with_deadline(self._not_empty,
                                       self._pop_many_locked, max_n, timeout)

    def _pop_many_locked(self, max_n: int) -> List[Job]:
        jobs: List[Job] = []
        while len(jobs) < max_n:
            job = self._pop_locked()
            if job is None:
                break
            jobs.append(job)
        return jobs

    def pop_express(self, max_n: int) -> List[Job]:
        """Express-lane drain: up to ``max_n`` *urgent-tier* jobs,
        non-blocking, round-robin across shards so one tenant's urgent
        burst cannot monopolize the lane. Quota still binds (urgency does
        not override isolation), and each popped job's items are charged
        to the tenant's DWRR deficit — allowed to go negative, i.e. the
        tenant *borrows* against its future turns and pays the express
        service back in the regular rotation, so long-run fairness shares
        are preserved."""
        with self._lock:
            jobs: List[Job] = []
            if not self._order:
                return jobs
            start = self._cursor % len(self._order)
            idle_scans = 0
            i = start
            while len(jobs) < max_n and idle_scans < len(self._order):
                tenant = self._order[i % len(self._order)]
                i += 1
                job = None
                if self._under_quota(tenant):
                    job = self._shards[tenant].pop_express(1)
                    job = job[0] if job else None
                if job is None:
                    idle_scans += 1
                    continue
                idle_scans = 0
                self._deficit[tenant] -= job.items      # borrow
                self._popped[tenant].add(job.job_id)
                jobs.append(job)
                if self.telemetry is not None:
                    self._tel_pop(tenant, job.items)
                    self.telemetry.registry.counter(
                        "queue.express_pops", tenant=tenant).add()
            return jobs

    def express_backlog(self) -> int:
        """Queued urgent-tier jobs across all shards (quota-capped shards
        included — their urgency surfaces once a slot frees)."""
        with self._lock:
            return sum(s.express_backlog() for s in self._shards.values())

    def _burst_cap(self, tenant: str) -> float:
        spec = self._spec(tenant)
        return getattr(spec, "burst_quantum", 0.0) or 0.0 \
            if spec is not None else 0.0

    def _eligible_head(self, tenant: str) -> Optional[Job]:
        if not self._under_quota(tenant):
            return None
        return self._shards[tenant].peek()

    def _advance_locked(self) -> None:
        self._cursor = (self._cursor + 1) % max(1, len(self._order))
        self._replenished = False

    def _pop_locked(self) -> Optional[Job]:
        heads = {t: self._eligible_head(t) for t in self._order}
        active = [t for t in self._order if heads[t] is not None]
        if not active:
            return None
        # the tenant's turn persists across pop() calls: it keeps serving
        # while its deficit covers its head, is credited quantum×weight at
        # most once per turn, and the rotation moves on when it cannot
        # afford its head (or empties / hits quota). Rounds in which no
        # tenant can afford its head even after its turn's credit are
        # fast-forwarded in one step — every active tenant banks the same
        # per-round quantum×weight it would have accumulated iterating,
        # so the scan below is O(tenants), not O(head/(quantum·weight)),
        # while the drain order is unchanged.
        needed = {
            t: math.ceil(max(0.0, heads[t].items - self._deficit[t])
                         / (self.quantum * self._weight(t)))
            for t in active}
        skip = max(0, min(needed.values()) - 1)
        if skip:
            for t in active:
                self._deficit[t] += skip * self.quantum * self._weight(t)
        # ≤1 rotation to finish any mid-turn state + ≤1 to reach the
        # first affordable tenant (its residual need is now ≤1 quantum)
        for _ in range(2 * len(self._order) + 2):
            tenant = self._order[self._cursor % len(self._order)]
            head = self._eligible_head(tenant)
            if head is None:
                if self._shards[tenant].peek() is None:
                    # empty shard leaves the round: banked credit capped
                    # at the tenant's burst quantum (0 = classic reset)
                    self._deficit[tenant] = min(self._deficit[tenant],
                                                self._burst_cap(tenant))
                self._advance_locked()      # empty or quota-capped
                continue
            if self._deficit[tenant] < head.items:
                if self._replenished:       # turn's credit already spent
                    self._advance_locked()
                    continue
                self._deficit[tenant] += self.quantum * self._weight(tenant)
                self._replenished = True
                if self._deficit[tenant] < head.items:
                    self._advance_locked()  # keep banking across rounds
                    continue
            self._deficit[tenant] -= head.items
            job = self._shards[tenant].pop()
            if job is not None:
                self._popped[tenant].add(job.job_id)
                if self.telemetry is not None:
                    self._tel_pop(tenant, job.items)
            return job
        return None                         # unreachable by construction

    # -- lifecycle passthrough ------------------------------------------
    def mark_running(self, job: Job, group: str = "*") -> None:
        with self._lock:
            self._shard(job.tenant).mark_running(job, group)

    def mark_finished(self, job: Job, state: JobState) -> None:
        with self._not_empty:
            self._shard(job.tenant).mark_finished(job, state)
            self._popped[job.tenant].discard(job.job_id)
            # a freed quota slot may unblock a capped shard's drain
            self._not_empty.notify()

    def requeue(self, job: Job) -> None:
        with self._not_empty:
            self._shard(job.tenant).requeue(job)
            self._not_empty.notify()
        self._notify_listeners()

    # -- introspection --------------------------------------------------
    def get(self, job_id: str) -> Optional[Job]:
        with self._lock:
            for shard in self._shards.values():
                job = shard.get(job_id)
                if job is not None:
                    return job
            return None

    def depth(self, tenant: Optional[str] = None) -> int:
        with self._lock:
            if tenant is not None:
                shard = self._shards.get(tenant)
                return shard.depth() if shard else 0
            return sum(s.depth() for s in self._shards.values())

    def backlog_items(self, tenant: Optional[str] = None) -> int:
        with self._lock:
            if tenant is not None:
                shard = self._shards.get(tenant)
                return shard.backlog_items() if shard else 0
            return sum(s.backlog_items() for s in self._shards.values())

    def backlog_by_tenant(self) -> Dict[str, int]:
        """Queued items per tenant — admission's per-tenant backlog view."""
        with self._lock:
            return {t: self._shards[t].backlog_items() for t in self._order}

    def outstanding(self, tenant: str) -> int:
        """Jobs popped but not yet finished — the quota the admission gate
        and the drain both enforce."""
        with self._lock:
            return len(self._popped.get(tenant, ()))

    def queued(self, tenant: str) -> int:
        """ADMITTED jobs not yet handed to the drain. Popped jobs stay
        ADMITTED until mark_running (two-phase pop), so a plain depth()
        would count them twice against a quota that also counts
        outstanding() — this view excludes them."""
        with self._lock:
            return self._queued_locked(tenant)

    def _queued_locked(self, tenant: str) -> int:
        shard = self._shards.get(tenant)
        if shard is None:
            return 0
        popped = self._popped.get(tenant, ())
        return sum(1 for j in shard.jobs(JobState.ADMITTED)
                   if j.job_id not in popped)

    def unfinished(self, tenant: str) -> int:
        """Queued + popped-but-unfinished, in ONE lock acquisition — the
        admission quota's denominator. Reading queued() and outstanding()
        separately lets a concurrent pop move a job between the two views
        mid-read and undercount by one."""
        with self._lock:
            return self._queued_locked(tenant) \
                + len(self._popped.get(tenant, ()))

    def inflight(self, group: Optional[str] = None) -> int:
        with self._lock:
            return sum(s.inflight(group) for s in self._shards.values())

    def jobs(self, state: Optional[JobState] = None) -> List[Job]:
        with self._lock:
            out: List[Job] = []
            for t in self._order:
                out.extend(self._shards[t].jobs(state))
            return out

    def counts(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for shard in self._shards.values():
                for k, v in shard.counts().items():
                    out[k] = out.get(k, 0) + v
            return out
