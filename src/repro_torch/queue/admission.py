"""Admission control: backpressure before work reaches the scheduler.

Capacity is estimated from the signals the runtime already produces — the
per-group λ-estimates of ThroughputTracker (eqs. 1–2) derated by the §3.3
overhead fractions of OverheadLedger (an accelerator spending 30% of its
busy time in O_hd/O_kl/O_dh is not a λ-worth of useful capacity). The
projected queue delay for a new job is then

    delay ≈ (backlog_items + job.items) / Σ_G λ_G · useful_G

and the decision is a three-way gate against the delay SLO:

    delay ≤ slo              → ADMIT
    delay ≤ defer_factor·slo → DEFER   (caller should retry; bounded queue)
    otherwise                → REJECT  (shed load instead of building an
                                        unbounded backlog — the queue
                                        stays inside the SLO envelope)

Group membership is event-driven: ElasticController join/leave and
scheduler group failures call on_group_join/on_group_leave, so capacity
reacts to topology changes without polling.

Straggler awareness: update_stragglers() feeds StragglerDetector reports
into the capacity model — a group observed slowing to fraction f of its
healthy baseline advertises only f of its λ-worth of capacity, so the
admission gate backs off *before* the watchdog declares the group dead
(the λ-EWMA alone reacts with the EWMA's lag; the derate is immediate
and baseline-relative).

Multi-tenant mode: with a ``registry`` (TenantRegistry) the gate becomes
per-tenant. A job is deferred when its tenant is at its in-flight quota
(outstanding + queued jobs ≥ max_inflight), and the delay gate projects
the *tenant's* queue delay against the *tenant's* SLO using the tenant's
DWRR fair-share of capacity:

    delay_t ≈ (backlog_t + job.items) / (capacity · w_t / Σ_{active} w)

where "active" is the set of currently backlogged tenants plus the
candidate — so an underloaded tenant admitting into an empty shard sees
(up to weighted contention) the full capacity, never another tenant's
backlog (work conservation at the admission gate, mirroring the DWRR
drain). Without a registry the legacy global gate is unchanged.

Idle probing (policy mode only): the capacity estimate is *measured* —
λ-EWMAs only move when chunks complete. A gate that defers everything
therefore freezes its own evidence: nothing runs, λ never refreshes, and
a stale-low estimate (e.g. one compile-polluted first batch) projects
every future job past the SLO forever. When the smoothed gate says
defer/reject but the gate's population is completely idle (zero backlog
AND zero unfinished work), the projection is unfalsifiable and the job
would start immediately — a queue-delay SLO cannot be violated — so the
gate admits it as a probe to refresh the estimate. Exactly one probe is
in flight per population (the probe itself becomes unfinished work, so
the next candidate defers normally).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from enum import Enum
from typing import Dict, Optional

from repro_torch import telemetry as telemetry_mod
from repro_torch.core.overheads import OverheadLedger
from repro_torch.core.throughput import ThroughputTracker
from repro_torch.queue import job as job_mod
from repro_torch.queue.job import Job, JobState
from repro_torch.queue.manager import QueueManager


class Decision(str, Enum):
    ADMIT = "admit"
    DEFER = "defer"
    REJECT = "reject"


@dataclass
class AdmissionDecision:
    decision: Decision
    projected_delay_s: float
    capacity_items_s: float
    reason: str = ""
    tenant: str = "default"

    def __bool__(self) -> bool:
        return self.decision == Decision.ADMIT


class AdmissionController:
    def __init__(self, queue: QueueManager,
                 tracker: Optional[ThroughputTracker] = None,
                 ledger: Optional[OverheadLedger] = None,
                 slo_delay_s: float = 1.0,
                 defer_factor: float = 4.0,
                 min_capacity: float = 1e-6,
                 registry=None, telemetry=None, clock=None, policy=None,
                 global_unfinished=None):
        self.queue = queue
        self.tracker = tracker
        self.ledger = ledger
        self.slo_delay_s = slo_delay_s
        self.defer_factor = defer_factor
        self.min_capacity = min_capacity
        # optional repro_torch.policy.AdaptivePolicy (duck-typed): smooths the
        # gate's projected delay over a sliding window (hysteresis — the
        # gate rises with a spike instantly, decays slowly) and gates
        # straggler rebalances behind a cooldown. None → point-in-time
        # decisions, the original behavior.
        self.policy = policy
        # injectable job-clock (tests/clock.py); default follows
        # repro_torch.queue.job.now at call time so a monkeypatched job clock
        # and the deadline gate can never disagree on "now"
        self._clock = clock
        # duck-typed TenantRegistry (repro_torch.tenancy.spec); None → tenant-
        # blind legacy gate. Kept untyped so repro_torch.queue never imports
        # repro_torch.tenancy at module scope (tenancy builds on queue).
        self.registry = registry
        # federation hook: callable(tenant) -> unfinished jobs FLEET-wide
        # (gossip-aggregated). The quota gate takes max(local, global) so
        # a tenant cannot multiply its in-flight quota by the number of
        # runtimes it spans. None → single-runtime behavior.
        self.global_unfinished = global_unfinished
        self._groups: Dict[str, float] = {}      # name -> λ seed
        self._derate: Dict[str, float] = {}      # name -> straggler factor
        self._lock = threading.Lock()
        # serializes admit(): the quota/delay gates are check-then-act
        # against queue state, and concurrent admits (submit vs. the
        # service loop's retry_deferred, or recover on a live daemon)
        # must not both pass a quota with one slot left — and the
        # decision counters must not lose updates
        self._admit_lock = threading.Lock()
        # counters for observability / tests
        self.admitted = 0
        self.deferred = 0
        self.rejected = 0
        # rejects whose cause was an unmeetable deadline (dead-on-arrival
        # shedding — serving them would burn capacity on a guaranteed
        # deadline miss); subset of ``rejected``
        self.deadline_rejects = 0
        # admits forced through a defer/reject verdict because the gate's
        # population was idle (see module docstring); subset of ``admitted``
        self.idle_probes = 0
        self.per_tenant: Dict[str, Dict[str, int]] = {}
        # metrics: admission.decisions{decision,tenant} counters plus a
        # projected-delay histogram (the gate's own view of backlog)
        self.telemetry = telemetry_mod.resolve(telemetry)
        self._tel: Dict[tuple, object] = {}

    def _tel_decision(self, decision: Decision, tenant: str,
                      delay: float) -> None:
        if self.telemetry is None:
            return
        key = (decision.value, tenant)
        c = self._tel.get(key)
        if c is None:
            c = self._tel[key] = self.telemetry.registry.counter(
                "admission.decisions", decision=decision.value,
                tenant=tenant)
        c.add(1)
        h = self._tel.get("delay")
        if h is None:
            h = self._tel["delay"] = self.telemetry.registry.histogram(
                "admission.projected_delay_s")
        h.observe(delay)

    def now(self) -> float:
        """Job-domain clock (see ``clock=``)."""
        return self._clock() if self._clock is not None else job_mod.now()

    # -- topology events (ElasticController / scheduler failures) ------
    def on_group_join(self, name: str, lam_seed: float = 1.0) -> None:
        with self._lock:
            self._groups[name] = lam_seed

    def on_group_leave(self, name: str) -> None:
        with self._lock:
            self._groups.pop(name, None)
            self._derate.pop(name, None)

    def groups(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._groups)

    # -- straggler derating (StragglerDetector reports) ----------------
    def update_stragglers(self, slowdowns: Dict[str, float]) -> None:
        """Replace the derate map from a detector observation: groups
        reported straggling advertise ``slowdown`` (current λ / healthy
        baseline, clamped to [0.05, 1.0]) of their capacity; groups no
        longer reported recover full weight.

        With a policy attached the proposed map must clear its rebalance
        gate first: insignificant changes are dropped, and significant
        ones inside the post-rebalance cooldown are suppressed (counted)
        so a group flapping around the straggler threshold cannot thrash
        the advertised capacity."""
        with self._lock:
            new = {name: min(1.0, max(0.05, f))
                   for name, f in slowdowns.items() if name in self._groups}
            old = dict(self._derate)
        if self.policy is not None and \
                not self.policy.allow_rebalance(self.now(), new, old):
            return
        with self._lock:
            self._derate = new

    def derate(self, name: str) -> float:
        with self._lock:
            return self._derate.get(name, 1.0)

    # -- capacity model ------------------------------------------------
    def _useful_fraction(self, group: str) -> float:
        """1 − offload-overhead share of the group's busy time."""
        if self.ledger is None:
            return 1.0
        tot = self.ledger.totals(group)
        if tot.n_chunks == 0:
            return 1.0
        busy = tot.kernel + tot.sp + tot.hd + tot.kl + tot.dh + tot.td
        if busy <= 0.0:
            return 1.0
        return max(0.1, tot.kernel / busy)

    def capacity_items_s(self) -> float:
        """Aggregate useful throughput (items/s) of live groups."""
        cap = 0.0
        for name, seed in self.groups().items():
            lam = self.tracker.get(name) if self.tracker is not None else seed
            if lam <= 0.0:
                lam = seed
            cap += lam * self._useful_fraction(name) * self.derate(name)
        return max(cap, self.min_capacity)

    def projected_delay_s(self, extra_items: int = 0) -> float:
        backlog = self.queue.backlog_items() + extra_items
        return backlog / self.capacity_items_s()

    # -- per-tenant views ----------------------------------------------
    def _tenant_weight(self, tenant: str) -> float:
        """The tenant's effective DWRR weight, as the queue drains it —
        delegated so admission's fair-share model can never drift from
        the drain's derate/floor policy."""
        effective = getattr(self.queue, "effective_weight", None)
        if effective is not None:
            return effective(tenant)
        return max(1e-9, self.registry.get(tenant).weight)

    def tenant_capacity_items_s(self, tenant: str) -> float:
        """The tenant's DWRR fair-share of aggregate useful capacity:
        full capacity when no other tenant is backlogged, its weight share
        among backlogged tenants otherwise."""
        cap = self.capacity_items_s()
        if self.registry is None:
            return cap
        by_tenant = getattr(self.queue, "backlog_by_tenant", None)
        if by_tenant is None:                # unsharded queue: no view
            return cap
        active = {t for t, b in by_tenant().items() if b > 0}
        active.add(tenant)
        wsum = sum(self._tenant_weight(t) for t in active)
        return max(cap * self._tenant_weight(tenant) / wsum,
                   self.min_capacity)

    def _tenant_backlog_items(self, tenant: str) -> int:
        if self.registry is not None \
                and hasattr(self.queue, "backlog_by_tenant"):
            return self.queue.backlog_items(tenant)
        return self.queue.backlog_items()

    def tenant_projected_delay_s(self, tenant: str,
                                 extra_items: int = 0) -> float:
        return (self._tenant_backlog_items(tenant) + extra_items) \
            / self.tenant_capacity_items_s(tenant)

    _COUNTER = {Decision.ADMIT: "admitted", Decision.DEFER: "deferred",
                Decision.REJECT: "rejected"}

    def _count(self, tenant: str, decision: Decision) -> None:
        bucket = self.per_tenant.setdefault(
            tenant, {"admitted": 0, "deferred": 0, "rejected": 0})
        bucket[self._COUNTER[decision]] += 1

    def _tenant_quota_free(self, job: Job) -> bool:
        """True while the tenant's unfinished admitted work (popped but
        unfinished + still queued) stays under its in-flight quota. The
        queued() view excludes popped jobs (which stay ADMITTED until
        mark_running) so work in the pop-to-dispatch window is not
        counted against the quota twice."""
        spec = self.registry.get(job.tenant)
        if spec.max_inflight is None:
            return True
        unfinished_fn = getattr(self.queue, "unfinished", None)
        if unfinished_fn is not None:
            # one atomic snapshot — a concurrent pop moving a job from
            # queued to popped between two separate reads would make the
            # gate undercount and admit past the quota
            unfinished = unfinished_fn(job.tenant)
        else:
            # unsharded queue: count THIS tenant's live jobs directly —
            # another tenant's backlog must never consume this tenant's
            # quota (and its own RUNNING jobs must)
            unfinished = sum(1 for j in self.queue.jobs()
                             if j.tenant == job.tenant
                             and j.state in (JobState.ADMITTED,
                                             JobState.RUNNING))
        if self.global_unfinished is not None:
            # the fleet view is one heartbeat stale and may lag the local
            # count it already includes — max() never double-counts and
            # enforces whichever bound is tighter
            unfinished = max(unfinished,
                             self.global_unfinished(job.tenant))
        return unfinished < spec.max_inflight

    def shed_deferred(self, job: Job) -> None:
        """Reclassify one DEFERred job as rejected — the service calls
        this when it sheds a deferred job (pool at capacity) so the
        counters report the job's final outcome, not the gate's initial
        answer."""
        with self._admit_lock:
            self.deferred -= 1
            self.rejected += 1
            if self.registry is not None:
                bucket = self.per_tenant.get(job.tenant)
                if bucket is not None:
                    bucket["deferred"] -= 1
                    bucket["rejected"] += 1

    # -- the gate ------------------------------------------------------
    def admit(self, job: Job) -> AdmissionDecision:
        """Decide on a PENDING job; ADMIT enqueues it, REJECT cancels it,
        DEFER leaves it PENDING for the caller to retry. With a tenant
        registry the delay gate is per-tenant (fair-share capacity vs. the
        tenant's own SLO) and an in-flight quota breach defers."""
        with self._admit_lock:
            return self._admit_locked(job)

    def _admit_locked(self, job: Job) -> AdmissionDecision:
        if job.deadline_s is not None:
            # deadline stamping: the absolute deadline rides the job's
            # metadata into the journal, so a recovered daemon enforces
            # the original budget, not one restarted at replay time
            job.meta.setdefault("deadline_at", job.deadline_at)
        if self.registry is None:
            return self._gate(job, self.capacity_items_s(),
                              self.queue.backlog_items(),
                              self.slo_delay_s, prefix="")
        spec = self.registry.get(job.tenant)
        cap_t = self.tenant_capacity_items_s(job.tenant)
        slo = spec.slo_delay_s if spec.slo_delay_s is not None \
            else self.slo_delay_s
        if not self._tenant_quota_free(job):
            delay = (self._tenant_backlog_items(job.tenant) + job.items) \
                / cap_t
            infeasible = self._deadline_infeasible(job, delay, cap_t)
            if infeasible is not None:
                return infeasible
            at_quota = f"tenant {job.tenant} at in-flight quota " \
                       f"{spec.max_inflight}"
            # the reject band still applies at quota — otherwise a flood
            # against a capped tenant is deferred forever and the
            # deferred pool (re-gated every service poll) grows without
            # bound instead of being shed like the tenant-blind gate does
            if delay > self.defer_factor * slo:
                return self._reject(
                    job, delay, cap_t,
                    f"{at_quota} and projected delay {delay:.3f}s > "
                    f"{self.defer_factor:.1f}×SLO")
            return self._defer(job, delay, cap_t, at_quota)
        return self._gate(job, cap_t,
                          self._tenant_backlog_items(job.tenant), slo,
                          prefix=f"tenant {job.tenant} ",
                          key=job.tenant)

    # shared decision bookkeeping: counters, per-tenant counters (registry
    # mode only), lifecycle transition and rejection metadata live here so
    # the global gate, the per-tenant gate, and the quota branch cannot
    # drift apart
    def _defer(self, job: Job, delay: float, cap: float,
               reason: str) -> AdmissionDecision:
        self.deferred += 1
        if self.registry is not None:
            self._count(job.tenant, Decision.DEFER)
        self._tel_decision(Decision.DEFER, job.tenant, delay)
        return AdmissionDecision(Decision.DEFER, delay, cap,
                                 tenant=job.tenant, reason=reason)

    def _reject(self, job: Job, delay: float, cap: float,
                reason: str) -> AdmissionDecision:
        job.meta["rejected_delay_s"] = delay
        job.transition(JobState.CANCELLED)
        self.rejected += 1
        if self.registry is not None:
            self._count(job.tenant, Decision.REJECT)
        self._tel_decision(Decision.REJECT, job.tenant, delay)
        return AdmissionDecision(Decision.REJECT, delay, cap,
                                 tenant=job.tenant, reason=reason)

    def _deadline_infeasible(self, job: Job, delay: float,
                             cap: float) -> Optional[AdmissionDecision]:
        """REJECT a deadline job whose projected queue delay already
        exceeds its remaining budget — admitting it could only produce a
        deadline miss after burning real capacity. None when feasible
        (or deadline-less)."""
        if job.deadline_s is None:
            return None
        remaining = job.deadline_at - self.now()
        if delay <= max(0.0, remaining):
            return None
        self.deadline_rejects += 1
        if self.telemetry is not None:
            self.telemetry.registry.counter(
                "admission.deadline_rejects", tenant=job.tenant).add()
            self.telemetry.tracer.instant(
                "deadline_reject", tid="admission", tenant=job.tenant,
                tier=job.tier, remaining_s=round(remaining, 6))
        job.meta["deadline_missed"] = True
        return self._reject(
            job, delay, cap,
            f"projected delay {delay:.3f}s exceeds remaining deadline "
            f"budget {remaining:.3f}s")

    def _population_unfinished(self, job: Job) -> int:
        """Unfinished (admitted-or-running) jobs in the gate population
        that would decide ``job`` — its tenant's shard in registry mode,
        the whole queue otherwise. Only consulted on the idle-probe path
        (gate said defer/reject AND backlog is zero), so the unsharded
        fallback scan is off the admit hot path."""
        if self.registry is not None:
            unfinished_fn = getattr(self.queue, "unfinished", None)
            if unfinished_fn is not None:
                return unfinished_fn(job.tenant)
            return sum(1 for j in self.queue.jobs()
                       if j.tenant == job.tenant
                       and j.state in (JobState.ADMITTED, JobState.RUNNING))
        return sum(1 for j in self.queue.jobs()
                   if j.state in (JobState.ADMITTED, JobState.RUNNING))

    def _gate(self, job: Job, cap: float, backlog: int, slo: float,
              prefix: str, key: str = "*") -> AdmissionDecision:
        """The three-band ADMIT/DEFER/REJECT ladder, shared by the legacy
        global gate and the per-tenant gate (which differ only in which
        capacity/backlog/SLO feed it — and, with a policy attached, in
        ``key``: each gate population smooths over its own window)."""
        delay = (backlog + job.items) / cap
        if self.policy is not None:
            # windowed smoothing (serialized by _admit_lock): reacts
            # instantly to rising load, projects the window's trend
            # forward, and — given the SLO — latches DEFER until the
            # recent high-water clears the band, killing ADMIT/DEFER
            # flapping on point-sample noise
            delay = self.policy.admission_delay(self.now(), delay,
                                                slo=slo, key=key)
        infeasible = self._deadline_infeasible(job, delay, cap)
        if infeasible is not None:
            return infeasible
        probe = False
        if delay > slo and self.policy is not None and backlog == 0 \
                and self._population_unfinished(job) == 0:
            # idle probe: with zero backlog and nothing unfinished the
            # stale-low λ that produced this verdict can never refresh —
            # deferring would livelock the population (see module
            # docstring). The job starts immediately, so the queue-delay
            # SLO is safe by construction.
            probe = True
            self.idle_probes += 1
            if self.telemetry is not None:
                self.telemetry.registry.counter(
                    "admission.idle_probes", tenant=job.tenant).add()
        if delay <= slo or probe:
            self.queue.put(job)
            self.admitted += 1
            if self.registry is not None:
                self._count(job.tenant, Decision.ADMIT)
            self._tel_decision(Decision.ADMIT, job.tenant, delay)
            return AdmissionDecision(Decision.ADMIT, delay, cap,
                                     tenant=job.tenant,
                                     reason="idle probe" if probe else "")
        if delay <= self.defer_factor * slo:
            return self._defer(job, delay, cap,
                               f"{prefix}projected delay {delay:.3f}s "
                               f"> SLO {slo:.3f}s")
        return self._reject(job, delay, cap,
                            f"{prefix}projected delay {delay:.3f}s > "
                            f"{self.defer_factor:.1f}×SLO")
