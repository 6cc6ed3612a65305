"""JobService: continuous drain of the queue into the persistent runtime.

Each batch pops up to ``batch_jobs`` jobs (priority order; one
``pop_many`` lock acquisition / DWRR pass when the queue supports the
batched drain), concatenates
their items into one iteration space, and submits it as an *epoch* on a
long-lived DynamicScheduler runtime — the paper's §3.1 pipeline is the
*execution* layer; this is the *admission-to-execution* bridge. The drain
is double-buffered (``pipeline_depth``, default 2): batch N+1 is popped,
marked RUNNING, and submitted while batch N's chunks are still in flight,
so the inter-batch barrier (scheduler rebuild + thread spawn + join) that
the rebuild-per-batch design paid disappears; benchmarks/batch_boundary.py
quantifies the difference. ``persistent=False`` restores the old
build-run-teardown behavior per batch (the benchmark baseline).

When a device group dies mid-epoch the scheduler's own chunk requeue
(work conservation on iteration count) still completes the epoch, so jobs
are DONE; an epoch that loses *all* groups completes only part of its
count, and since the runtime conserves count, not iteration identity,
there is no way to attribute the partial completion to specific jobs —
the whole batch is REQUEUED (at-least-once semantics, bounded by
``max_attempts``). A runtime with no live groups left is rebuilt from
``make_scheduler`` before the next batch. This is the ChunkFailure →
requeue conversion the fault-tolerance layer promises.

Group failures observed in an epoch (in-band ChunkFailure) and hangs
caught by the runtime Watchdog both flow to the AdmissionController as
on_group_leave events, shrinking advertised capacity immediately; a
StragglerDetector, when attached, derates a slowing group's advertised
capacity *before* it is declared dead.
"""
from __future__ import annotations

import collections
import logging
import math
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch import telemetry as telemetry_mod
from repro_torch.core.scheduler import DynamicScheduler, EpochHandle, \
    ScheduleResult
from repro_torch.core.types import IterationSpace, TIERS
from repro_torch.queue import job as job_mod
from repro_torch.queue.job import IllegalTransition, Job, JobState
from repro_torch.queue.admission import AdmissionController, AdmissionDecision, \
    Decision
from repro_torch.queue.journal import JournalStore
from repro_torch.queue.manager import QueueManager

try:                                    # optional hang detection
    from repro_torch.runtime.fault_tolerance import Watchdog
except Exception:                       # pragma: no cover
    Watchdog = None                     # type: ignore

try:                                    # optional straggler derating
    from repro_torch.runtime.straggler import StragglerDetector
except Exception:                       # pragma: no cover
    StragglerDetector = None            # type: ignore

logger = logging.getLogger(__name__)

clock = time.monotonic


def percentiles(xs: Sequence[float],
                ps: Sequence[float] = (50.0, 95.0, 99.0)) \
        -> Dict[str, float]:
    """Nearest-rank percentiles, {"p50": ..} — no numpy dependency here."""
    out: Dict[str, float] = {}
    if not xs:
        return {f"p{p:g}": 0.0 for p in ps}
    s = sorted(xs)
    for p in ps:
        k = max(0, min(len(s) - 1, math.ceil(p / 100.0 * len(s)) - 1))
        out[f"p{p:g}"] = s[k]
    return out


@dataclass
class BatchReport:
    jobs: List[Job]
    completed_items: int
    total_items: int
    failed_groups: List[str]
    schedule: Optional[ScheduleResult] = None
    submitted_at: float = 0.0
    finished_at: float = 0.0


@dataclass
class ServiceStats:
    batches: int = 0
    done: int = 0
    failed: int = 0
    requeues: int = 0
    queue_delays: List[float] = field(default_factory=list)
    per_group_items: Dict[str, int] = field(default_factory=dict)
    errors: List[str] = field(default_factory=list)
    # batches submitted before the previous batch finished — the
    # double-buffered drain working (counted incrementally)
    overlapped: int = 0
    # latency-tier bookkeeping: per-tier deadline misses (shed at pop or
    # cancelled in flight), express-lane batches, cancelled batches
    deadline_misses: Dict[str, int] = field(default_factory=dict)
    express_batches: int = 0
    cancelled_batches: int = 0
    # (submitted_at, finished_at) monotonic stamps of recent batches;
    # capped so a long-lived daemon's memory stays bounded
    batch_windows: List[Tuple[float, float]] = field(default_factory=list)
    WINDOW_CAP = 10_000

    def delay_percentiles(self) -> Dict[str, float]:
        return percentiles(self.queue_delays)

    def overlapped_batches(self) -> int:
        """Batches submitted before the previous batch finished."""
        return self.overlapped

    def record_window(self, submitted_at: float, finished_at: float) -> None:
        if self.batch_windows and submitted_at < self.batch_windows[-1][1]:
            self.overlapped += 1
        if len(self.batch_windows) < self.WINDOW_CAP:
            self.batch_windows.append((submitted_at, finished_at))


class DrainWakeup:
    """Event-driven wakeup for the drain loop — replaces the fixed
    ``poll_s`` sleep that made the service trade idle CPU burn against
    dispatch latency. ``notify`` is fan-in from every source of new
    drain work: queue arrival listeners (put/requeue), epoch
    done-callbacks (completion frees a pipeline slot), submit(), and
    stop(). ``wait`` parks the drain thread until a notify or a fallback
    timeout (liveness backstop for duck-typed queues without listeners).

    Lost-notify safety: every notify happens AFTER its state change is
    visible, and the loop always pumps after waking — so a notify that
    races the event-clear can at worst cause one extra (cheap) pump, never
    a missed job. Counters are plain ints (GIL-atomic +=, observability
    only): ``event_wakeups`` vs ``timeout_wakeups`` is the idle-efficiency
    signal scripts/smoke.sh asserts on.
    """

    def __init__(self):
        self._event = threading.Event()
        self.notified = 0
        self.event_wakeups = 0
        self.timeout_wakeups = 0

    def notify(self, *_args) -> None:
        """Signal work. Extra args ignored so the same bound method serves
        as a queue listener (no args) and an epoch done-callback (handle)."""
        self.notified += 1
        self._event.set()

    def wait(self, timeout: float) -> bool:
        """Block until notified (True) or ``timeout`` elapses (False);
        consumes the notification."""
        woke = self._event.wait(timeout)
        if woke:
            self._event.clear()
            self.event_wakeups += 1
        else:
            self.timeout_wakeups += 1
        return woke

    def consume(self) -> bool:
        """Non-blocking: consume a pending notification if present. The
        injected-sleep (virtual-clock) drain path uses this so event
        arrival short-circuits the virtual sleep deterministically."""
        if self._event.is_set():
            self._event.clear()
            self.event_wakeups += 1
            return True
        return False

    def stats(self) -> Dict[str, float]:
        return {"notified": float(self.notified),
                "event_wakeups": float(self.event_wakeups),
                "timeout_wakeups": float(self.timeout_wakeups)}


@dataclass
class _InflightBatch:
    jobs: List[Job]
    total: int
    submitted_at: float
    handle: Optional[EpochHandle] = None
    error: Optional[BaseException] = None
    tier: str = "standard"
    # earliest member deadline on the *service* monotonic clock (the job
    # clock and scheduler clock are different domains; bridged at submit)
    deadline_mono: Optional[float] = None
    express: bool = False


class JobService:
    def __init__(self, make_scheduler: Callable[[], DynamicScheduler],
                 queue: Optional[QueueManager] = None,
                 admission: Optional[AdmissionController] = None,
                 journal: Optional[JournalStore] = None,
                 batch_jobs: int = 8, poll_s: float = 0.05,
                 watchdog: Optional["Watchdog"] = None,
                 on_group_failed: Optional[Callable[[str], None]] = None,
                 pipeline_depth: int = 2, persistent: bool = True,
                 straggler: Optional["StragglerDetector"] = None,
                 accountant=None, max_deferred: int = 10_000,
                 telemetry=None, express: bool = True,
                 express_slots: int = 1, clock=None, sleep=None,
                 fallback_s: float = 2.0,
                 health_poll_s: Optional[float] = None,
                 retry_budget: int = 20, retry_base_s: float = 0.02,
                 retry_max_s: float = 1.0,
                 brownout_factor: Optional[float] = None,
                 brownout_after_s: float = 1.0):
        self.make_scheduler = make_scheduler
        # monotonic clock / sleep seams for the deterministic test
        # harness; the ctor arg shadows the module global, hence the
        # globals() reach-around for the default
        self.clock = clock if clock is not None else globals()["clock"]
        self._sleep = sleep if sleep is not None else time.sleep
        # express lane: urgent-tier jobs bypass the pipeline-depth gate
        # (up to express_slots extra batches in flight beyond depth)
        self.express = express
        self.express_slots = max(1, express_slots)
        self.queue = queue or QueueManager()
        self.admission = admission
        self.journal = journal
        self.batch_jobs = max(1, batch_jobs)
        self.poll_s = poll_s
        # event-driven drain: the loop parks on ``wakeup`` and is woken
        # by queue arrivals, epoch completions, and submit/stop;
        # ``fallback_s`` is the liveness backstop (large — events are the
        # primary mechanism), tightened to ``health_poll_s`` when a
        # watchdog/straggler monitor is attached because hangs generate
        # no events and must be caught by polling
        self.fallback_s = fallback_s
        self.health_poll_s = health_poll_s if health_poll_s is not None \
            else max(poll_s, 0.1)
        self.wakeup = DrainWakeup()
        # with an injected sleep (virtual-clock harness) the drain stays
        # on the deterministic sleep path: virtual-time advance IS the
        # wakeup, a real Event.wait would deadlock run_until_idle
        self._injected_sleep = sleep is not None
        add_listener = getattr(self.queue, "add_listener", None)
        if add_listener is not None:
            add_listener(self.wakeup.notify)
        self.watchdog = watchdog
        self.on_group_failed = on_group_failed
        self.pipeline_depth = max(1, pipeline_depth)
        self.persistent = persistent
        self.straggler = straggler
        # duck-typed repro_torch.tenancy.TenantAccountant: attributes each
        # finalized batch's busy time / joules to tenants and feeds soft
        # energy-budget weight derates back into a sharded queue (kept
        # untyped so repro_torch.queue never imports repro_torch.tenancy)
        self.accountant = accountant
        # ceiling on the deferred pool: every deferred job is re-gated
        # each poll, so an unbounded pool is both a memory leak and O(n)
        # lock-held work per loop — beyond the cap, DEFER becomes REJECT
        self.max_deferred = max_deferred
        # bounded deferred-retry policy: each re-offer that DEFERs again
        # backs off exponentially (base * 2^n, capped, jittered so a
        # burst of deferrals doesn't re-offer in lockstep); after
        # ``retry_budget`` failed re-offers the job goes terminal FAILED
        # instead of looping forever against a gate that will never open
        self.retry_budget = max(1, retry_budget)
        self.retry_base_s = retry_base_s
        self.retry_max_s = retry_max_s
        self._retry_rng = random.Random(0xC0FFEE)   # jitter only; seeded
        self._retry_at: Dict[str, float] = {}       # job_id -> eligible at
        # graceful brownout: when admission's projected delay exceeds
        # ``brownout_factor × slo`` continuously for ``brownout_after_s``,
        # shed queued batch-tier work; another sustained interval sheds
        # standard; urgent is shed last. None disables the controller.
        self.brownout_factor = brownout_factor
        self.brownout_after_s = brownout_after_s
        self._brownout_since: Optional[float] = None
        self._brownout_level = 0
        self.stats = ServiceStats()
        self._deferred: List[Job] = []
        # deferred jobs taken out by retry_deferred and not yet back in
        # the pool or the queue: an idle check from another thread (the
        # federation's) must count them, or it sees the service idle
        self._retrying = 0
        # job ids already replayed by recover(): a journal recovered twice
        # (or two replicas overlapping after a messy failover) must not
        # double-enqueue the same job. Bounded by jobs ever recovered.
        self._recovered_ids: set = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._sched: Optional[DynamicScheduler] = None
        self._inflight: Deque[_InflightBatch] = collections.deque()
        # service-layer metrics: batch throughput counters, per-tenant
        # queue-delay histograms, and snapshot-time gauges for the
        # deferred pool / in-flight pipeline / queue depth
        self.telemetry = telemetry_mod.resolve(telemetry)
        self._tel: Dict[str, object] = {}
        if self.telemetry is not None:
            self.telemetry.registry.add_collector(self._collect)

    # -- telemetry plumbing --------------------------------------------
    def _counter(self, name: str, **labels):
        key = (name,) + tuple(sorted(labels.items()))
        c = self._tel.get(key)
        if c is None:
            c = self._tel[key] = self.telemetry.registry.counter(
                name, **labels)
        return c

    def _histogram(self, name: str, **labels):
        key = ("h", name) + tuple(sorted(labels.items()))
        h = self._tel.get(key)
        if h is None:
            h = self._tel[key] = self.telemetry.registry.histogram(
                name, **labels)
        return h

    def _collect(self) -> None:
        reg = self.telemetry.registry
        with self._lock:
            deferred = len(self._deferred)
        reg.gauge("svc.deferred_jobs").set(deferred)
        reg.gauge("svc.inflight_batches").set(len(self._inflight))
        try:
            reg.gauge("svc.queue_depth").set(self.queue.depth())
        except Exception:       # duck-typed queue without depth()
            pass

    def telemetry_snapshot(self) -> Optional[Dict]:
        """Merged metrics snapshot, or None when uninstrumented."""
        if self.telemetry is None:
            return None
        return self.telemetry.snapshot()

    # -- journaling ----------------------------------------------------
    def _journal(self, job: Job, event: Optional[str] = None) -> None:
        if self.journal is not None:
            self.journal.record(job, event)

    # -- submission ----------------------------------------------------
    def submit(self, job: Job) -> AdmissionDecision:
        """Admission-gate a PENDING job. DEFERred jobs are retried by the
        service loop as backlog drains; REJECTed jobs come back CANCELLED."""
        self._journal(job, "submitted")
        if self.admission is None:
            self.queue.put(job)
            self._journal(job)
            self.wakeup.notify()    # covers duck-typed queues without
            return AdmissionDecision(   # arrival listeners
                Decision.ADMIT, 0.0, float("inf"))
        dec = self.admission.admit(job)
        if dec.decision == Decision.ADMIT:
            self.wakeup.notify()
        if dec.decision == Decision.DEFER:
            with self._lock:
                full = len(self._deferred) >= self.max_deferred
                if not full:
                    self._deferred.append(job)
            if full:                        # shed: a flood (e.g. against
                job.meta["rejected_delay_s"] = dec.projected_delay_s
                job.transition(JobState.CANCELLED)   # a quota-capped
                self.admission.shed_deferred(job)    # tenant) must not
                self._journal(job, "rejected")       # bank unboundedly
                return AdmissionDecision(
                    Decision.REJECT, dec.projected_delay_s,
                    dec.capacity_items_s, tenant=job.tenant,
                    reason=f"deferred pool at capacity "
                           f"({self.max_deferred})")
        self._journal(job, "rejected" if dec.decision == Decision.REJECT
                      else None)
        return dec

    def retry_deferred(self) -> int:
        """Re-offer deferred jobs to the admission gate; returns #admitted.

        Bounded: a job is re-offered only once its backoff window has
        passed (first retry immediately; each further DEFER doubles the
        wait, capped at ``retry_max_s`` and jittered ±50 % so deferred
        floods don't re-offer in lockstep). A job whose ``retry_budget``
        is exhausted goes terminal FAILED — unbounded immediate retry
        against a gate that never opens was both a livelock and O(pool)
        lock-held work per poll.
        """
        if self.admission is None:
            return 0
        now = self.clock()
        with self._lock:
            waiting, self._deferred = self._deferred, []
            self._retrying += len(waiting)
        try:
            return self._reoffer(waiting, now)
        finally:
            with self._lock:
                self._retrying -= len(waiting)

    def _reoffer(self, waiting: List[Job], now: float) -> int:
        if waiting and self._sched is not None \
                and not self._sched.live_groups():
            # every group died while the backlog sat deferred: with
            # nothing queued, no batch start will rebuild the runtime,
            # admission capacity stays pinned at min_capacity, and the
            # re-offer loop would burn its whole retry budget against a
            # gate that can never open — rebuild before re-offering
            self._scheduler()
        admitted = 0
        still: List[Job] = []
        for job in waiting:
            if job.state != JobState.PENDING:      # cancelled while waiting
                self._retry_at.pop(job.job_id, None)
                continue
            if self._retry_at.get(job.job_id, -math.inf) > now:
                still.append(job)                  # backoff not elapsed
                continue
            dec = self.admission.admit(job)
            if dec.decision != Decision.DEFER:
                self._retry_at.pop(job.job_id, None)
                self._journal(job)
                admitted += dec.decision == Decision.ADMIT
                continue
            n = int(job.meta.get("retries", 0)) + 1
            job.meta["retries"] = n
            if self.telemetry is not None:
                self._counter("svc.retries", cause="deferred").add(1)
            if n >= self.retry_budget:
                job.meta["failure"] = \
                    f"deferred retry budget exhausted ({n})"
                job.transition(JobState.FAILED)
                self.admission.shed_deferred(job)
                self.stats.failed += 1
                self._retry_at.pop(job.job_id, None)
                self._journal(job, "retry-exhausted")
                if self.telemetry is not None:
                    self._counter("svc.retries", cause="exhausted").add(1)
                continue
            back = min(self.retry_max_s,
                       self.retry_base_s * (2 ** (n - 1)))
            back *= 0.5 + self._retry_rng.random()
            self._retry_at[job.job_id] = now + back
            still.append(job)
        if still:
            with self._lock:
                self._deferred.extend(still)
        if admitted:
            self.wakeup.notify()
        return admitted

    # -- brownout (graceful overload shedding) -------------------------
    def _shed_tier(self, tier: str) -> int:
        """Cancel every queued (ADMITTED) job of one tier. In-flight
        batches are left to finish — brownout sheds *waiting* load."""
        shed = 0
        try:
            queued = self.queue.jobs(state=JobState.ADMITTED)
        except TypeError:               # duck-typed queue without filter
            queued = [j for j in self.queue.jobs()
                      if j.state == JobState.ADMITTED]
        for j in queued:
            if j.tier != tier:
                continue
            if not self.queue.cancel(j.job_id):
                continue
            j.meta["brownout"] = True
            self._journal(j, "brownout-shed")
            shed += 1
        if shed and self.telemetry is not None:
            self._counter("svc.brownout", tier=tier).add(shed)
        return shed

    def _check_brownout(self) -> None:
        """Overload controller: sustained projected delay beyond
        ``brownout_factor × slo`` sheds queued tiers lowest-value-first
        (batch → standard → urgent), one tier per sustained
        ``brownout_after_s`` interval; recovery (delay back within slo)
        resets fully. ``svc.brownout{tier=}`` counts shed jobs and the
        ``svc.brownout_level`` gauge exposes the current level."""
        if self.admission is None or self.brownout_factor is None:
            return
        slo = getattr(self.admission, "slo_delay_s", math.inf)
        if not math.isfinite(slo):
            return
        now = self.clock()
        delay = self.admission.projected_delay_s()
        if delay > self.brownout_factor * slo:
            if self._brownout_since is None:
                self._brownout_since = now
            level = min(len(TIERS), int((now - self._brownout_since)
                                        / self.brownout_after_s))
            while self._brownout_level < level:
                # shed lowest-value first: batch, then standard, urgent
                tier = TIERS[len(TIERS) - 1 - self._brownout_level]
                n = self._shed_tier(tier)
                self._brownout_level += 1
                logger.warning("brownout level %d: shed %d %s-tier "
                               "job(s) (projected delay %.3fs, slo "
                               "%.3fs)", self._brownout_level, n, tier,
                               delay, slo)
                if self.telemetry is not None:
                    self.telemetry.tracer.instant(
                        "brownout", tid="service",
                        level=self._brownout_level, tier=tier, shed=n)
        elif delay <= slo and self._brownout_level:
            logger.info("brownout cleared (projected delay %.3fs)", delay)
            self._brownout_level = 0
            self._brownout_since = None
        elif delay <= slo:
            self._brownout_since = None
        if self.telemetry is not None:
            self.telemetry.registry.gauge("svc.brownout_level") \
                .set(self._brownout_level)

    # -- replay-driven restart -----------------------------------------
    def recover(self, journal_path: str) -> List[Job]:
        """Rebuild queue state from a crashed process's journal into THIS
        (live) service: in-flight jobs of the dead process re-enter the
        queue — routed to their tenant's shard when the queue is sharded —
        and PENDING jobs get a fresh admission decision. Safe to call
        while the drain daemon is running (the queue is thread-safe and
        the daemon simply starts popping recovered work). Returns the
        re-materialized jobs; terminal history stays in the journal.

        A RUNNING job at crash time comes back REQUEUED (its attempt died
        with the process — at-least-once, bounded by max_attempts); the
        per-tenant in-flight view starts clean because nothing recovered
        is actually on a scheduler yet.

        Replay is deduplicated by job id: recovering the same journal
        twice, or a journal whose jobs this service already holds (e.g.
        a replica overlapping the primary), skips the duplicates instead
        of double-enqueueing them.
        """
        to_requeue, _ = JournalStore.recover(journal_path)
        get = getattr(self.queue, "get", None)
        restored: List[Job] = []
        for job in to_requeue:
            if job.job_id in self._recovered_ids \
                    or (get is not None and get(job.job_id) is not None):
                continue
            self._recovered_ids.add(job.job_id)
            if job.state == JobState.REQUEUED:
                if job.attempts_left <= 0:
                    job.transition(JobState.FAILED)
                    self.stats.failed += 1
                    self._journal(job, "recovery-exhausted")
                    continue
                self.queue.requeue(job)
            elif job.state == JobState.ADMITTED:
                self.queue.put(job)
            else:                              # PENDING: re-gate it
                self.submit(job)
                restored.append(job)
                continue
            self._journal(job, "recovered")
            restored.append(job)
        return restored

    # -- the persistent runtime ----------------------------------------
    def _scheduler(self) -> DynamicScheduler:
        """Live runtime, rebuilt from the factory only when every group
        has died (the persistent-runtime analogue of per-batch rebuild)."""
        s = self._sched
        if s is not None and s.live_groups():
            return s
        rebuilt = s is not None
        if s is not None:
            s.shutdown()
        s = self.make_scheduler()
        s.start()
        self._sched = s
        if rebuilt:
            # the factory brings the same group names back: clear the
            # watchdog's sticky dead verdicts and restore admission
            # capacity for groups whose death was observed (without this
            # the rebuilt runtime serves at zero advertised capacity and
            # one hang per group name is terminal for the service)
            for g in s.live_groups():
                if self.watchdog is not None:
                    self.watchdog.revive(g)
                if self.admission is not None \
                        and g not in self.admission.groups():
                    # rejoin at the λ-tracker's estimate (measurement or
                    # seed), not a blind 1.0: if the group died before
                    # its first chunk completed, a 1.0 seed projects a
                    # huge delay, every deferred re-offer re-defers,
                    # nothing queues, and λ can never be measured — a
                    # deadlock broken only by retry-budget exhaustion
                    tracker = getattr(s, "tracker", None)
                    lam = tracker.get(g) if tracker is not None else 1.0
                    self.admission.on_group_join(g, lam)
        return s

    def scheduler(self) -> Optional[DynamicScheduler]:
        """The live runtime, if one has been built."""
        return self._sched

    # -- health signals ------------------------------------------------
    def _poll_health(self) -> None:
        if self.watchdog is not None:
            for g in self.watchdog.check():
                if self._sched is not None:
                    self._sched.remove_group(g)
                if self.admission is not None:
                    self.admission.on_group_leave(g)
                if self.on_group_failed is not None:
                    self.on_group_failed(g)
        if self.straggler is not None and self.admission is not None:
            reports = self.straggler.observe()
            self.admission.update_stragglers(
                {r.group: r.slowdown for r in reports})

    # -- batch pipeline ------------------------------------------------
    def _pop_batch(self, block_s: float = 0.0) -> List[Job]:
        """Form one scheduler batch. Queues with a batched drain
        (``pop_many``: one lock acquisition / one DWRR pass for the whole
        batch) are preferred; job-at-a-time pop is the fallback for
        duck-typed queues without it."""
        pop_many = getattr(self.queue, "pop_many", None)
        if pop_many is not None:
            return pop_many(self.batch_jobs, timeout=block_s or None)
        jobs: List[Job] = []
        first = self.queue.pop(timeout=block_s or None)
        if first is None:
            return jobs
        jobs.append(first)
        while len(jobs) < self.batch_jobs:
            nxt = self.queue.pop()
            if nxt is None:
                break
            jobs.append(nxt)
        return jobs

    def _record_deadline_miss(self, job: Job, where: str) -> None:
        """Per-tier deadline-miss bookkeeping (stats + telemetry +
        journal). ``where`` is the enforcement point: "pop" (expired
        before dispatch) or "cancel" (in-flight epoch cancelled)."""
        job.meta["deadline_missed"] = True
        self.stats.deadline_misses[job.tier] = \
            self.stats.deadline_misses.get(job.tier, 0) + 1
        if self.telemetry is not None:
            self._counter("svc.deadline_misses", tier=job.tier).add(1)
            self.telemetry.tracer.instant(
                "deadline_miss", tid="service", job=job.job_id,
                tier=job.tier, where=where)
        self._journal(job, "deadline-miss")

    def _submit_batch(self, jobs: List[Job],
                      express: bool = False) -> Optional[BatchReport]:
        """Mark a batch RUNNING and submit its epoch. On submit failure the
        batch is finalized immediately (returns its report); otherwise it
        joins the in-flight pipeline and None is returned. Jobs cancelled
        in the pop-to-dispatch window (two-phase pop leaves them ADMITTED
        and cancellable) are dropped here, not crashed on; jobs already
        past their deadline are shed here (CANCELLED, counted as misses)
        rather than burning device time on work nobody can use."""
        live = []
        jnow = job_mod.now()
        for j in jobs:
            if j.deadline_at is not None and jnow > j.deadline_at:
                try:                        # expired while queued
                    self.queue.mark_finished(j, JobState.CANCELLED)
                except IllegalTransition:
                    pass                    # already terminal elsewhere
                else:
                    self._record_deadline_miss(j, where="pop")
                continue
            try:
                self.queue.mark_running(j)
            except IllegalTransition:       # cancelled while popped
                self._journal(j)
                continue
            self._journal(j)
            live.append(j)
        if not live:
            return None
        jobs = live
        total = sum(j.items for j in jobs)
        # the batch runs at the tier of its most urgent member, and its
        # epoch inherits the earliest member deadline, bridged from the
        # job (wall) clock to the scheduler (monotonic) clock
        tier = TIERS[min(j.rank for j in jobs)]
        deadlines = [j.deadline_at for j in jobs
                     if j.deadline_at is not None]
        deadline_mono = self.clock() + (min(deadlines) - jnow) \
            if deadlines else None
        ib = _InflightBatch(jobs=jobs, total=total,
                            submitted_at=self.clock(), tier=tier,
                            deadline_mono=deadline_mono, express=express)
        if express:
            self.stats.express_batches += 1
            if self.telemetry is not None:
                self._counter("svc.express_batches").add(1)
        if not self.persistent:
            return self._run_batch_sync(ib)
        try:
            sched = self._scheduler()
            ib.handle = sched.submit_epoch(IterationSpace(0, total),
                                           priority=tier,
                                           deadline_s=deadline_mono)
            # completion wakes the drain (frees a pipeline slot / lets a
            # finalized batch's backlog re-gate deferred jobs)
            add_cb = getattr(ib.handle, "add_done_callback", None)
            if add_cb is not None:
                add_cb(self.wakeup.notify)
            if self.telemetry is not None:
                # register the batch's tenant composition against the
                # epoch index BEFORE any chunk completes, so chunk spans
                # carry tenant tags at export time (the scheduler itself
                # conserves iteration count, not job identity)
                tenants: Dict[str, int] = {}
                for j in jobs:
                    tenants[j.tenant] = tenants.get(j.tenant, 0) + j.items
                self.telemetry.tracer.tag_epoch(
                    ib.handle.index, {"tenants": tenants,
                                      "jobs": len(jobs), "tier": tier})
        except Exception as e:          # broken factory / submit: fail the
            ib.error = e                # batch, not the daemon
            logger.exception("batch of %d jobs failed to submit", len(jobs))
            return self._finalize_batch(ib)
        self._inflight.append(ib)
        return None

    def _run_batch_sync(self, ib: _InflightBatch) -> BatchReport:
        """Rebuild-per-batch compat mode: fresh scheduler, one-shot run
        (thread spawn + join per batch — the benchmark baseline)."""
        try:
            sched = self.make_scheduler()
            res = sched.run(0, ib.total)
            ib.handle = _DoneHandle(res, ib.submitted_at)
        except Exception as e:
            ib.error = e
            logger.exception("batch of %d jobs failed to run", len(ib.jobs))
        return self._finalize_batch(ib)

    def _finalize_batch(self, ib: _InflightBatch) -> BatchReport:
        res: Optional[ScheduleResult] = None
        completed, failed_groups = 0, []
        if ib.error is not None:
            if len(self.stats.errors) < 100:
                self.stats.errors.append(repr(ib.error))
            for j in ib.jobs:
                j.meta["last_error"] = repr(ib.error)
        else:
            res = ib.handle.result()
            completed, failed_groups = res.iterations, res.failed_groups
            for g, n in res.per_group_items.items():
                self.stats.per_group_items[g] = \
                    self.stats.per_group_items.get(g, 0) + n

        for g in failed_groups:
            if self.admission is not None:
                self.admission.on_group_leave(g)
            if self.on_group_failed is not None:
                self.on_group_failed(g)

        # all-or-nothing per batch: the runtime conserves iteration COUNT,
        # not identity (a re-executed chunk is fresh range at the end of
        # the space), so a partial count cannot be attributed to specific
        # jobs — never mark a job DONE whose items may not have run
        done = completed >= ib.total
        cancelled = res is not None and res.cancelled
        if cancelled:
            self.stats.cancelled_batches += 1

        # per-tenant attribution + soft energy-budget weight derating
        # (before job finalization so the very next DWRR pop sees it).
        # Completed batches only: a failed batch's jobs requeue and run
        # again in full, so attributing the failed attempt too would
        # double-count the tenant's items and inflate its fairness share.
        # A *cancelled* batch DID consume device time and joules that no
        # retry gives back, so those are charged — but without the item
        # counts, which the eventual completing attempt will charge
        if self.accountant is not None and res is not None \
                and (done or cancelled):
            self.accountant.record_batch(
                ib.jobs, res, window=(ib.submitted_at, self.clock()),
                count_items=done)
            derates = self.accountant.derate_weights()
            set_derates = getattr(self.queue, "set_weight_derates", None)
            if set_derates is not None:
                set_derates(derates)
        tel = self.telemetry
        jnow = job_mod.now()
        for j in ib.jobs:
            if done:
                self.queue.mark_finished(j, JobState.DONE)
                self.stats.done += 1
                if j.queue_delay is not None:
                    self.stats.queue_delays.append(j.queue_delay)
                    if self.accountant is not None:
                        self.accountant.record_queue_delay(j.tenant,
                                                           j.queue_delay)
                    if tel is not None:
                        self._histogram("queue.queue_delay_s",
                                        tenant=j.tenant) \
                            .observe(j.queue_delay)
                        self._histogram("svc.latency_s", tier=j.tier) \
                            .observe(max(0.0, jnow - j.created_at))
                state = "done"
            elif cancelled and j.deadline_at is not None \
                    and jnow >= j.deadline_at:
                # the epoch was cancelled and this job's own budget is
                # spent: retrying cannot meet it — shed, not requeue
                self.queue.mark_finished(j, JobState.CANCELLED)
                self._record_deadline_miss(j, where="cancel")
                state = "cancelled"
            elif j.attempts_left > 0:
                self.queue.mark_finished(j, JobState.REQUEUED)
                self.queue.requeue(j)
                self.stats.requeues += 1
                if tel is not None:
                    self._counter("svc.retries",
                                  cause="batch_failure").add(1)
                state = "requeued"
            else:
                self.queue.mark_finished(j, JobState.FAILED)
                self.stats.failed += 1
                state = "failed"
            if tel is not None:
                self._counter("svc.jobs", state=state, tenant=j.tenant) \
                    .add(1)
            self._journal(j)
        self.stats.batches += 1
        finished = self.clock()
        self.stats.record_window(ib.submitted_at, finished)
        if tel is not None:
            self._counter("svc.batches").add(1)
            self._counter("svc.batch_items").add(min(completed, ib.total))
            tel.tracer.span(f"batch:{self.stats.batches}", tid="service",
                            start=ib.submitted_at, end=finished,
                            jobs=len(ib.jobs), items=ib.total, done=done,
                            tier=ib.tier, cancelled=cancelled)
        return BatchReport(ib.jobs, min(completed, ib.total), ib.total,
                           list(failed_groups), res,
                           submitted_at=ib.submitted_at,
                           finished_at=finished)

    def _pump_express(self) -> bool:
        """Express lane: drain urgent-tier jobs PAST the pipeline-depth
        gate (up to ``express_slots`` extra batches in flight). The
        urgent epoch preempts queued standard work inside the scheduler,
        so a cold-arriving urgent job is served within one batch boundary
        instead of waiting out the full double-buffered pipeline."""
        if not self.express or not self.persistent:
            return False
        pop_express = getattr(self.queue, "pop_express", None)
        if pop_express is None:
            return False
        progressed = False
        while sum(1 for ib in self._inflight if ib.express) \
                < self.express_slots:
            jobs = pop_express(self.batch_jobs)
            if not jobs:
                break
            self._submit_batch(jobs, express=True)
            progressed = True
        return progressed

    def _enforce_deadlines(self) -> None:
        """Cooperatively cancel in-flight epochs whose batch deadline has
        passed — workers wind down at the next chunk boundary and the
        unfinished tail requeues via finalization."""
        if self._sched is None:
            return
        now = self.clock()
        for ib in self._inflight:
            if ib.deadline_mono is None or now <= ib.deadline_mono:
                continue
            if isinstance(ib.handle, EpochHandle) and not ib.handle.done():
                self._sched.cancel_epoch(ib.handle, reason="deadline")

    def _pump(self, block_s: float = 0.0) -> bool:
        """One pipeline step: keep up to ``pipeline_depth`` batches in
        flight (plus the express lane), enforce batch deadlines, finalize
        completed ones. Returns whether any batch was submitted or
        finalized. Express batches finalize out of order (they finish
        early by design — never leave one blocked behind a long batch
        epoch at the pipeline head)."""
        progressed = self._pump_express()
        self._enforce_deadlines()
        while sum(1 for ib in self._inflight if not ib.express) \
                < self.pipeline_depth:
            jobs = self._pop_batch(0.0 if (self._inflight or progressed)
                                   else block_s)
            if not jobs:
                break
            rep = self._submit_batch(jobs)
            progressed = True
            self._pump_express()            # urgent work that arrived
            self._enforce_deadlines()       # while we blocked in pop
            if rep is not None:             # sync mode / submit failure
                break
        for ib in list(self._inflight):     # out-of-order completions
            if ib is not self._inflight[0] and ib.handle is not None \
                    and ib.handle.done():
                self._inflight.remove(ib)
                self._finalize_batch(ib)
                progressed = True
        while self._inflight:
            # block only when no new batch can be submitted anyway (full
            # pipeline, or an idle pass) — otherwise just poll
            full = len(self._inflight) >= self.pipeline_depth
            timeout = block_s if (full or not progressed) else 0.0
            if not self._inflight[0].handle.wait(timeout):
                break
            self._finalize_batch(self._inflight.popleft())
            progressed = True
        return progressed

    # -- one-shot drains (compat + tests) ------------------------------
    def drain_once(self, block_s: float = 0.0) -> Optional[BatchReport]:
        """Pop one batch, run it to completion, finalize. Any batches
        already in the pipeline are finalized first (submission order)."""
        while self._inflight:
            ib = self._inflight.popleft()
            ib.handle.wait()
            self._finalize_batch(ib)
        jobs = self._pop_batch(block_s)
        if not jobs:
            return None
        rep = self._submit_batch(jobs)
        if rep is not None:
            return rep
        if not self._inflight:              # whole batch cancelled in the
            return None                     # pop-to-dispatch window
        ib = self._inflight.popleft()
        ib.handle.wait()
        return self._finalize_batch(ib)

    def run_until_idle(self, timeout_s: float = 60.0) -> bool:
        """Drain (pipelined) until queue + deferred + in-flight are empty;
        False on timeout."""
        deadline = self.clock() + timeout_s
        while self.clock() < deadline:
            self.retry_deferred()
            self._poll_health()
            self._check_brownout()
            if self._pump(block_s=0.0):
                continue
            if not self._inflight:
                with self._lock:
                    idle = not self._deferred
                if idle and self.queue.depth() == 0:
                    return True
            self._wait_for_work(limit=deadline - self.clock())
        return False

    # -- daemon mode ---------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="job-service", daemon=True)
        self._thread.start()

    def stop(self, join: bool = True) -> None:
        self._stop.set()
        self.wakeup.notify()        # unpark the drain immediately
        if join and self._thread is not None:
            self._thread.join(timeout=10.0)
        self._thread = None
        # finalize whatever the daemon left in flight (runtime is alive)
        while self._inflight:
            ib = self._inflight.popleft()
            if ib.handle is not None and not ib.handle.wait(10.0):
                ib.error = TimeoutError("epoch unfinished at stop()")
            self._finalize_batch(ib)

    def close(self) -> None:
        """Stop the daemon (if running) and shut the runtime down."""
        self.stop()
        if self._sched is not None:
            self._sched.shutdown()
            self._sched = None

    def crash(self) -> None:
        """Kill this runtime the unclean way (failover tests, federation
        ``kill_runtime``): stop the drain WITHOUT finalizing in-flight
        batches — their jobs stay RUNNING, exactly the state a process
        death leaves in the journal — and tear the scheduler down,
        cancelling live epochs at the next chunk boundary so worker
        threads wind up. Recovery is a survivor's job: replay the
        (mirrored) journal via ``recover`` on a live service."""
        self._stop.set()
        self.wakeup.notify()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        sched = self._sched
        if sched is not None:
            for ib in self._inflight:
                if isinstance(ib.handle, EpochHandle) \
                        and not ib.handle.done():
                    sched.cancel_epoch(ib.handle, reason="crash")
            sched.shutdown()
            self._sched = None
        self._inflight.clear()

    def _next_deadline_delay(self) -> Optional[float]:
        """Seconds until the earliest in-flight batch deadline (service
        clock), or None — bounds the drain's park time so deadline
        enforcement never waits on an unrelated event."""
        best: Optional[float] = None
        if self._inflight:
            now = self.clock()
            for ib in self._inflight:
                if ib.deadline_mono is None:
                    continue
                d = ib.deadline_mono - now
                if best is None or d < best:
                    best = d
        return best

    def _wait_for_work(self, limit: Optional[float] = None) -> None:
        """Park the drain until new work can arrive: a wakeup event
        (arrival/completion/submit/stop) or a fallback timeout. The
        timeout is ``fallback_s`` tightened by the health-poll cadence
        (watchdog/straggler attached — hangs emit no events), the nearest
        in-flight deadline, and the caller's ``limit``."""
        timeout = self.fallback_s
        if self.watchdog is not None or self.straggler is not None:
            timeout = min(timeout, self.health_poll_s)
        d = self._next_deadline_delay()
        if d is not None:
            timeout = min(timeout, max(d, 1e-4))
        if limit is not None:
            timeout = min(timeout, max(limit, 0.0))
        if self._injected_sleep:
            # deterministic harness: consuming a pending event replaces
            # the virtual sleep; otherwise advance virtual time one poll
            if not self.wakeup.consume():
                self._sleep(self.poll_s)
                self.wakeup.consume()
            return
        woke = self.wakeup.wait(timeout)
        if self.telemetry is not None:
            self._counter("svc.drain_wakeups",
                          cause="event" if woke else "timeout").add(1)

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.retry_deferred()
            self._poll_health()
            self._check_brownout()
            if self._pump(block_s=0.0):
                continue
            self._wait_for_work()


class _DoneHandle:
    """Adapter giving a completed one-shot run the EpochHandle surface."""

    def __init__(self, res: ScheduleResult, submitted_at: float):
        self._res = res
        self.submitted_at = submitted_at
        self.started_at = submitted_at
        self.finished_at = clock()

    def done(self) -> bool:
        return True

    def wait(self, timeout: Optional[float] = None) -> bool:
        return True

    def result(self, timeout: Optional[float] = None) -> ScheduleResult:
        return self._res
