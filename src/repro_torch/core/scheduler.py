"""The Dynamic scheduler — the paper's §3.1 two-filter pipeline as a
*persistent* thread-per-device-group runtime.

Each device group gets a long-lived host (dispatcher) thread. Threads block
on an epoch queue and process successive IterationSpaces without teardown,
so the per-batch cost the paper attributes to the host side (thread
creation/wake-up, O_td, scheduler construction) is paid once per runtime,
not once per batch:

  start()                      spawn dispatcher threads once
  submit_epoch(space) -> EpochHandle
                               enqueue an iteration space; workers pick it
                               up as soon as their previous epoch's space
                               is exhausted (epochs overlap: a fast group
                               starts epoch N+1 while a slow group is still
                               draining epoch N — no global barrier)
  shutdown()                   drain queued epochs, then join threads
  run(begin, end)              one-shot compat wrapper (auto start; auto
                               shutdown if this call started the runtime)

Within an epoch each thread repeatedly runs the paper's pipeline:
  Filter₁: asks the partitioner for a token (device pick + chunk extraction),
           timestamped Tc1→Tc2;
  Filter₂: hands the token to the group's executor (which fills the device
           timestamps Tg1..Tg5), finalizes at Tc3, and feeds the throughput
           tracker and overhead ledger.

λ-EWMAs (ThroughputTracker), the partitioner's group membership, and
dead-group knowledge all live at runtime scope and carry across epochs.

Fault tolerance: a ChunkFailure re-queues the in-flight chunk(s) and removes
the group from the runtime (specs, executors, partitioner) — it stays
excluded in later epochs; remaining groups absorb the work (work
conservation is property-tested). Elasticity: add_group() mid-run spawns a
new dispatcher thread that joins the oldest open epoch; remove_group()
drains a group out everywhere.
"""
from __future__ import annotations

import collections
import logging
import threading
import traceback
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple, Union

from repro_torch import telemetry as telemetry_mod
from repro_torch.core.dispatch import (ChunkExecutor, ChunkFailure, clock,
                                      part_device_s, phase_fractions)
from repro_torch.core.overheads import OverheadLedger
from repro_torch.core.partitioner import HeterogeneousPartitioner
from repro_torch.core.throughput import ThroughputTracker
from repro_torch.core.types import ChunkRecord, GroupSpec, IterationSpace, \
    tier_rank

logger = logging.getLogger(__name__)

#: rank sentinel meaning "no runnable epoch": above every real tier rank,
#: so the preempt check `_preempt_rank < epoch.rank` is always False
_NO_RANK = 1 << 10


@dataclass
class ScheduleResult:
    total_time: float
    iterations: int
    records: List[ChunkRecord]
    overheads: Dict[str, Dict[str, float]]
    throughput: Dict[str, float]
    per_group_items: Dict[str, int]
    failed_groups: List[str] = field(default_factory=list)
    # latency-tier support: a cooperatively cancelled epoch finalizes with
    # ``cancelled=True`` and its undone tail in ``unfinished`` (completed
    # + unfinished == submitted items when no chunk re-executed), so the
    # service can requeue exactly what was cut off
    cancelled: bool = False
    cancel_reason: str = ""
    unfinished: int = 0

    def busy_seconds(self) -> Dict[str, float]:
        busy: Dict[str, float] = {}
        for r in self.records:
            busy[r.token.group] = busy.get(r.token.group, 0.0) \
                + max(r.device_time, 0.0)
        return busy


class EpochHandle:
    """Ticket for one submitted IterationSpace on the persistent runtime.

    ``submitted_at`` / ``started_at`` (first token handed out) /
    ``finished_at`` are monotonic-clock stamps; the gap between one epoch's
    ``finished_at`` and the next epoch's ``started_at`` is the batch-boundary
    overhead benchmarks/batch_boundary.py measures.

    ``priority`` is a latency tier (core.types.TIERS): dispatchers always
    pick the best-(rank, index) open epoch with takeable work, so an
    urgent epoch jumps queued standard/batch work and *preempts* running
    lower-tier epochs at their next chunk boundary. ``deadline_s`` is an
    absolute scheduler-clock deadline; blowing it cancels the epoch
    cooperatively (see DynamicScheduler.cancel_epoch).
    """

    def __init__(self, index: int, space: IterationSpace,
                 priority: str = "standard",
                 deadline_s: Optional[float] = None,
                 now: Optional[float] = None):
        self.index = index
        self.space = space
        self.priority = priority
        self.rank = tier_rank(priority)
        self.deadline_s = deadline_s
        self.cancelled = False
        self.cancel_reason: Optional[str] = None
        self.submitted_at = now if now is not None else clock()
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.ledger = OverheadLedger()          # per-epoch §3.3 fractions
        self.ledger.keep_records = False        # records live in _records
        self._records: List[ChunkRecord] = []
        self._failed: List[str] = []
        self._event = threading.Event()
        self._result: Optional[ScheduleResult] = None
        self._cb_lock = threading.Lock()
        self._callbacks: List = []

    @property
    def finalized(self) -> bool:
        return self._event.is_set()

    def add_done_callback(self, fn) -> None:
        """Call ``fn(self)`` when the epoch finalizes (immediately if it
        already has). Callbacks run on the finalizing dispatcher thread
        while the runtime lock is held, so they must be cheap and
        non-blocking — setting an event, bumping a counter. The JobService
        drain loop uses this for event-driven wakeups on completion."""
        with self._cb_lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> ScheduleResult:
        if not self._event.wait(timeout):
            raise TimeoutError(f"epoch {self.index} still in flight")
        return self._result


class DynamicScheduler:
    def __init__(self, groups: Dict[str, GroupSpec],
                 executors: Dict[str, ChunkExecutor],
                 alpha: float = 1.0, base_quantum: int = 256,
                 chunk_mode: str = "range", finalize_batch: int = 8,
                 telemetry=None, clock=None, adaptive_refill: bool = True):
        assert set(groups) == set(executors)
        self.specs = dict(groups)
        self.executors = dict(executors)
        # history-driven refill sizing (see HeterogeneousPartitioner.
        # _refill_quota_locked) — on by default for the runtime; "paper"
        # chunk mode takes per-token grants and never consults the quota,
        # so bit-compatibility is unaffected either way
        self.adaptive_refill = adaptive_refill
        # injectable time source (tests/clock.py VirtualClock): every
        # scheduler-side stamp and deadline comparison goes through it
        self.clock = clock if clock is not None else globals()["clock"]
        self.alpha = alpha
        self.base_quantum = base_quantum
        self.chunk_mode = chunk_mode
        # always-on observability: None → the process-wide default
        # Telemetry; repro_torch.telemetry.OFF → uninstrumented (the
        # benchmarks/telemetry_overhead.py baseline). The dispatch hot
        # path only *banks* finished completion batches (one GIL-atomic
        # deque append per finalize batch); the per-record work —
        # histograms, counters, chunk spans — runs in _tel_drain on the
        # snapshot reader's thread, so instrumentation adds neither
        # shared-lock contention nor per-chunk GIL pressure.
        self.telemetry = telemetry_mod.resolve(telemetry)
        self._tel_group: Dict[str, tuple] = {}
        # banked (epoch_index, records) batches awaiting ingestion;
        # bounded so a daemon nobody ever snapshots cannot pin every
        # ChunkRecord forever — overflow evicts oldest (counted)
        self._tel_pending: collections.deque = collections.deque(
            maxlen=8192)
        self._tel_lost = 0
        if self.telemetry is not None:
            self.telemetry.registry.add_collector(self._tel_drain)
        # per-worker completion buffers flush into the (locked) tracker /
        # ledgers every finalize_batch records instead of per record;
        # paper mode keeps the original record-at-a-time behavior
        self.finalize_batch = 1 if chunk_mode == "paper" \
            else max(1, finalize_batch)
        self.tracker = ThroughputTracker(alpha)
        self.ledger = OverheadLedger()          # cumulative, runtime lifetime
        self.ledger.keep_records = False        # fractions only: a runtime-
        # lifetime record list would grow without bound on a serve daemon
        # (per-epoch records live in each ScheduleResult)
        self.partitioner: Optional[HeterogeneousPartitioner] = None
        self._threads: Dict[str, threading.Thread] = {}
        self._cv = threading.Condition()
        # open (and recently finalized) epochs; finalized handles are
        # pruned from the front once every worker is past them, so a
        # long-lived daemon does not accumulate one handle per batch.
        # _epoch_base is the absolute index of _epochs[0].
        self._epochs: Deque[EpochHandle] = collections.deque()
        self._epoch_base = 0
        # name -> index of the next epoch the dispatcher will work on; an
        # epoch E may finalize only once every live worker's position is
        # past E (otherwise a thread that has not reached E yet could still
        # absorb E's requeued work)
        self._worker_pos: Dict[str, int] = {}
        # best (lowest) tier rank among open epochs with takeable work —
        # the lock-free preemption hint workers read at every chunk
        # boundary. Recomputed under _cv at every queue-shape change and
        # repaired by _await_epoch, so staleness only costs a spurious
        # drain/re-enter, never a missed wakeup.
        self._preempt_rank = _NO_RANK
        self._failed: List[str] = []
        self._started = False
        self._shutdown = False

    # -- runtime lifecycle ---------------------------------------------
    def start(self) -> None:
        """Spawn the dispatcher threads (idempotent)."""
        with self._cv:
            if self._started:
                return
            self._started = True
            # the partitioner is runtime-scoped: group membership, the
            # accel reference, and (via the shared tracker) λ-EWMAs carry
            # across epochs; each epoch swaps in a fresh space
            self.partitioner = HeterogeneousPartitioner(
                IterationSpace(0, 0), self.specs, self.tracker,
                self.base_quantum, chunk_mode=self.chunk_mode,
                adaptive_refill=self.adaptive_refill,
                telemetry=self.telemetry
                if self.telemetry is not None else telemetry_mod.OFF)
            for name in list(self.specs):
                self._spawn_locked(name, 0)

    def _spawn_locked(self, name: str, start_idx: int) -> None:
        self._worker_pos[name] = start_idx
        th = threading.Thread(target=self._worker, args=(name, start_idx),
                              name=f"dispatch-{name}", daemon=True)
        self._threads[name] = th
        th.start()

    def submit_epoch(self, space: Union[IterationSpace, Tuple[int, int]],
                     priority: str = "standard",
                     deadline_s: Optional[float] = None) -> EpochHandle:
        """Enqueue an iteration space for the dispatcher threads.

        ``priority`` is a latency tier (``urgent``/``standard``/``batch``):
        dispatchers enter the best-(rank, submission-order) open epoch
        with work, so an urgent epoch overtakes queued lower-tier epochs
        and pulls workers out of running ones at their next chunk
        boundary. ``deadline_s`` is an absolute deadline on this
        scheduler's clock; an epoch past it is cancelled cooperatively
        and finalizes with its unfinished tail counted."""
        if isinstance(space, tuple):
            space = IterationSpace(*space)
        self.start()
        with self._cv:
            if self._shutdown:
                raise RuntimeError("scheduler runtime is shut down")
            handle = EpochHandle(self._epoch_base + len(self._epochs),
                                 space, priority=priority,
                                 deadline_s=deadline_s, now=self.clock())
            self._epochs.append(handle)
            self.partitioner.begin_epoch(space)
            self._recompute_preempt_locked()
            if self.telemetry is not None:
                self.telemetry.registry.counter(
                    "sched.epochs_submitted", tier=priority).add()
                self.telemetry.tracer.instant(
                    "epoch_submit", tid="epochs", epoch=handle.index,
                    items=space.remaining, tier=priority)
            if not self._worker_pos:        # every group already dead
                self._finalize_epoch_locked(handle)
                self._prune_epochs_locked()
            self._cv.notify_all()
        return handle

    def cancel_epoch(self, handle: EpochHandle,
                     reason: str = "cancelled") -> bool:
        """Cooperatively cancel an epoch: flag it, reclaim every group's
        unconsumed private range back into its space (the unfinished tail
        then shows up as ``space.remaining`` → ``result.unfinished``), and
        wake the dispatchers — workers inside notice at their next chunk
        boundary, wind down the executor pipeline (completing what is
        already finished, requeueing the rest), and leave. Completed work
        is never retracted: returns False if the epoch already finalized
        (or was already cancelled), and a chunk in flight at the flag
        check completes and is counted (cancellation is chunk-granular).
        """
        with self._cv:
            if handle.finalized or handle.cancelled:
                return False
            handle.cancelled = True
            handle.cancel_reason = reason
            if self.partitioner is not None:
                self.partitioner.reclaim_space(handle.space)
            self._recompute_preempt_locked()
            self._maybe_finalize_locked(handle)
            self._prune_epochs_locked()
            self._cv.notify_all()
        if self.telemetry is not None:
            self.telemetry.registry.counter("sched.epochs_cancelled",
                                            reason=reason).add()
            self.telemetry.tracer.instant(
                "epoch_cancel", tid="epochs", epoch=handle.index,
                reason=reason, tier=handle.priority,
                unfinished=handle.space.remaining)
        return True

    def shutdown(self, wait: bool = True) -> None:
        """Drain queued epochs, then stop and join dispatcher threads."""
        with self._cv:
            if not self._started:
                return
            self._shutdown = True
            self._cv.notify_all()
            threads = list(self._threads.values())
        if wait:
            for th in threads:
                th.join(timeout=30.0)
        with self._cv:
            for h in self._epochs:          # workers died / none left
                if not h.finalized:
                    self._finalize_epoch_locked(h)
        if self.telemetry is not None:
            # flush banked completion batches now: once this scheduler is
            # dropped its weak collector dies and they would be lost to
            # any later exporter snapshot
            self._tel_drain()

    # -- introspection -------------------------------------------------
    def dispatchers(self) -> Dict[str, threading.Thread]:
        """Live view of the dispatcher threads (for reuse assertions)."""
        with self._cv:
            return dict(self._threads)

    def live_groups(self) -> List[str]:
        with self._cv:
            return list(self.specs)

    @property
    def failed_groups(self) -> List[str]:
        with self._cv:
            return list(self._failed)

    # -- compat one-shot API -------------------------------------------
    def run(self, begin: int, end: int) -> ScheduleResult:
        """One-shot wrapper: submit a single epoch and wait for it.

        If this call started the runtime it also shuts it down, preserving
        the pre-persistent contract (no threads outlive the call); on an
        already-started runtime the threads are reused and stay up.
        """
        was_started = self._started
        handle = self.submit_epoch(IterationSpace(begin, end))
        res = handle.result()
        if not was_started:
            self.shutdown()
        return res

    # -- elasticity ----------------------------------------------------
    def add_group(self, spec: GroupSpec, executor: ChunkExecutor) -> None:
        """Elastic scale-up: the newcomer joins the oldest open epoch."""
        with self._cv:
            self.specs[spec.name] = spec
            self.executors[spec.name] = executor
            if not self._started or self._shutdown:
                return
            self.partitioner.add_group(spec)
            start_idx = next((h.index for h in self._epochs
                              if not h.finalized),
                             self._epoch_base + len(self._epochs))
            self._spawn_locked(spec.name, start_idx)
            self._cv.notify_all()

    def remove_group(self, name: str) -> None:
        """Elastic leave: remove the group everywhere (specs, executors,
        partitioner); its dispatcher thread drains and exits."""
        with self._cv:
            self.specs.pop(name, None)
            self.executors.pop(name, None)
            if self.partitioner is not None:
                self.partitioner.remove_group(name)
            self._cv.notify_all()

    # -- dispatcher thread ---------------------------------------------
    def _worker(self, name: str, start_idx: int) -> None:
        ex = self.executors.get(name)
        if ex is None:                      # removed before first epoch
            self._retire_worker(name)
            return
        try:
            ex.on_worker_start()
        except Exception:
            pass
        idx = start_idx
        epoch: Optional[EpochHandle] = None
        try:
            while True:
                epoch = self._await_epoch(name, idx)
                if epoch is None:
                    break
                idx = epoch.index + 1
                if not self._run_epoch(name, ex, epoch):
                    break                   # group failed: thread retires
        except BaseException as e:
            self._dispatcher_guard(name, epoch, e)
        finally:
            self._retire_worker(name)

    def _dispatcher_guard(self, name: str, epoch: Optional["EpochHandle"],
                          err: BaseException) -> None:
        """Last-resort handler for a non-ChunkFailure escape from a
        dispatcher thread: convert it to group death through the normal
        death path instead of a silent thread exit. Without this a
        poisoned executor (raising outside the in-band protocol) left
        the group registered but unserved, so every epoch touching it
        stalled forever. The traceback lands in the log and telemetry."""
        tb = traceback.format_exc()
        logger.error("dispatcher thread for group %r died: %s", name, tb)
        if name in self.specs:              # not yet marked by _run_epoch
            self._mark_failed(name, epoch)
        if self.telemetry is not None:
            self.telemetry.registry.counter(
                "sched.dispatcher_errors", group=name).add()
            self.telemetry.tracer.instant(
                "dispatcher_error", tid="events", group=name,
                error=repr(err), traceback=tb[-2000:])

    def _best_open_locked(self) -> Optional[EpochHandle]:
        """Best-(tier rank, submission order) open epoch with takeable
        work — where an idle dispatcher should go. "Takeable" includes
        another group's unconsumed private range (the end-of-space steal
        source), so priority never disables work stealing."""
        part = self.partitioner
        best = None
        for h in self._epochs:
            if h.finalized or h.cancelled:
                continue
            if best is not None and h.rank >= best.rank:
                continue                    # _epochs is submission-ordered
            if h.space.remaining > 0 or (part is not None
                                         and part.has_work(h.space)):
                best = h
        return best

    def _recompute_preempt_locked(self) -> None:
        best = self._best_open_locked()
        self._preempt_rank = best.rank if best is not None else _NO_RANK

    def _await_epoch(self, name: str, idx: int) -> Optional[EpochHandle]:
        """Block until an epoch is available; None on shutdown / group
        removal. Entering is atomic with the finalized check so no
        records land on a finalized epoch.

        Epoch choice is priority-first: the best-(rank, index) open epoch
        with takeable work wins, wherever it sits relative to this
        worker's last position — an urgent epoch submitted late overtakes
        queued standard work, and a worker *revisits* an older open epoch
        whose space regained work (a failure requeued chunks after this
        worker had already left it). With no runnable epoch the worker
        walks forward past finalized ones so exhausted-but-open epochs
        behind it can finalize."""
        with self._cv:
            while True:
                if name not in self.specs:
                    return None
                idx = max(idx, self._epoch_base)
                best = self._best_open_locked()
                self._preempt_rank = best.rank if best is not None \
                    else _NO_RANK
                if best is not None:
                    idx = best.index
                else:
                    while idx - self._epoch_base < len(self._epochs) \
                            and self._epochs[idx
                                             - self._epoch_base].finalized:
                        idx += 1
                self._worker_pos[name] = idx
                # a priority jump can carry this worker past an open epoch
                # it never re-enters; once every worker is past one whose
                # work is done, nothing else would finalize it
                for h in self._epochs:
                    if h.index >= idx:
                        break
                    self._maybe_finalize_locked(h)
                if idx - self._epoch_base < len(self._epochs):
                    epoch = self._epochs[idx - self._epoch_base]
                    if epoch.started_at is None:
                        epoch.started_at = self.clock()
                    return epoch
                if self._shutdown:
                    return None
                self._cv.wait()

    def _run_epoch(self, name: str, ex: ChunkExecutor,
                   epoch: EpochHandle) -> bool:
        """Process one epoch's tokens; returns False if the group died.

        Finished records are buffered per worker and flushed into the
        shared ledgers in batches of ``finalize_batch`` (one lock
        acquisition per batch instead of per record); every failure/exit
        path flushes its buffer before this worker leaves the epoch
        (the ``finally`` below), so no finished work is lost and no
        epoch finalizes with records still parked in a buffer."""
        part = self.partitioner
        space = epoch.space
        buf: List[ChunkRecord] = []
        ok = True
        preempted = False
        try:
            while True:
                # chunk-boundary checks, cheapest first: the cancellation
                # flag and the preemption hint are plain attribute reads
                # (no lock); the deadline comparison reads the clock only
                # when a deadline is actually set
                if epoch.cancelled:
                    return self._wind_down_cancelled(name, ex, epoch, buf)
                if epoch.deadline_s is not None \
                        and self.clock() > epoch.deadline_s:
                    self.cancel_epoch(epoch, reason="deadline")
                    continue                # re-check hits the cancel path
                if self._preempt_rank < epoch.rank:
                    preempted = True        # a more urgent epoch has work:
                    break                   # drain the pipeline and jump
                tc1 = self.clock()
                token = part.next_token(name, space)
                tc2 = self.clock()
                if token is None:
                    break
                rec = ChunkRecord(token, tc1=tc1, tc2=tc2)
                try:
                    done = ex.execute(token, rec)
                except ChunkFailure:
                    self._stamp_tc3(ex.completed(), buf)
                    part.requeue(token.chunk, space)
                    for chunk in ex.abort():
                        part.requeue(chunk, space)
                    self._finalize(buf, epoch)
                    self._mark_failed(name, epoch)
                    return False
                except Exception:
                    # out-of-protocol escape: conserve work like the
                    # in-band path (requeue the in-flight token and
                    # whatever the executor can abort) before the raise
                    # reaches the dispatcher guard — otherwise the epoch
                    # loses the token's items and never completes
                    try:
                        self._stamp_tc3(ex.completed(), buf)
                    except Exception:
                        pass
                    part.requeue(token.chunk, space)
                    try:
                        for chunk in ex.abort():
                            part.requeue(chunk, space)
                    except Exception:
                        pass
                    self._finalize(buf, epoch)
                    self._mark_failed(name, epoch)
                    raise
                self._stamp_tc3(done, buf)
                if len(buf) >= self.finalize_batch:
                    self._finalize(buf, epoch)
            try:
                self._stamp_tc3(ex.drain(), buf)
            except ChunkFailure:
                self._stamp_tc3(ex.completed(), buf)
                for chunk in ex.abort():
                    part.requeue(chunk, space)
                self._finalize(buf, epoch)
                self._mark_failed(name, epoch)
                return False
            if preempted and self.telemetry is not None:
                self.telemetry.registry.counter(
                    "sched.preemptions", group=name).add()
                self.telemetry.tracer.instant(
                    "preempt", tid="events", group=name, epoch=epoch.index,
                    tier=epoch.priority)
        except BaseException:
            ok = False
            raise
        finally:
            self._finalize(buf, epoch)
            self._leave_epoch(name, epoch)
        return ok

    def _wind_down_cancelled(self, name: str, ex: ChunkExecutor,
                             epoch: EpochHandle,
                             buf: List[ChunkRecord]) -> bool:
        """Cancellation wind-down at a chunk boundary: keep what already
        finished (ex.cancel completes ready work without waiting on the
        rest), requeue the still-in-flight chunks into the epoch's space
        — joining the tail cancel_epoch already reclaimed — and leave.
        Runs inside _run_epoch's try, so the caller's ``finally`` still
        flushes ``buf`` and leaves the epoch."""
        part = self.partitioner
        try:
            self._stamp_tc3(ex.cancel(), buf)
        except ChunkFailure:
            self._stamp_tc3(ex.completed(), buf)
            for chunk in ex.abort():
                part.requeue(chunk, epoch.space)
            self._finalize(buf, epoch)
            self._mark_failed(name, epoch)
            return False
        for chunk in ex.abort():
            part.requeue(chunk, epoch.space)
        return True

    def _stamp_tc3(self, done: List[ChunkRecord],
                   buf: List[ChunkRecord]) -> None:
        """Move completed records into the worker's buffer, stamping Tc3
        (host resumed) and feeding the λ-tracker *now* — at
        execute-return, not at the batched flush — so buffering neither
        inflates O_td nor lets a group size its next chunk/range from a
        λ that predates its own completions (the slow-group rebalance
        would lag an epoch otherwise). Pipelined executors stamp Tc3 per
        record at completion themselves
        (dispatch.JaxChunkExecutor._complete_oldest); the stamp here is
        the fallback for synchronous executors only."""
        if not done:
            return
        t = self.clock()
        for rec in done:
            if rec.tc3 == 0.0:
                rec.tc3 = t
        self.tracker.update_many(done)
        buf.extend(done)

    def _finalize(self, recs: List[ChunkRecord], epoch: EpochHandle) -> None:
        """Flush a batch of finished records into the shared ledgers and
        the epoch's record list (one lock acquisition per batch instead
        of per record). Every record arrives via _stamp_tc3, so Tc3 and
        the λ-tracker are already handled. Clears ``recs``."""
        if not recs:
            return
        self.ledger.add_many(recs)
        epoch.ledger.add_many(recs)
        epoch._records.extend(recs)
        if self.telemetry is not None:
            # bank the batch for snapshot-time ingestion: one atomic
            # append — the only telemetry cost on the dispatch hot path
            pending = self._tel_pending
            if len(pending) == pending.maxlen:
                self._tel_lost += 1
            pending.append((epoch.index, tuple(recs)))
        del recs[:]

    def _tel_handles(self, group: str) -> tuple:
        """Per-group metric handles, bound once (registry get-or-create
        takes a lock; the flush path must not)."""
        h = self._tel_group.get(group)
        if h is None:
            reg = self.telemetry.registry
            h = self._tel_group[group] = (
                reg.counter("sched.chunks", group=group),
                reg.counter("sched.items", group=group),
                reg.histogram("sched.chunk_host_s", group=group),
                reg.histogram("sched.chunk_device_s", group=group))
        return h

    def _tel_drain(self) -> None:
        """Snapshot-time collector: ingest banked completion batches into
        metrics + chunk spans. Runs on the snapshot reader's thread (the
        exporter daemon or a telemetry_snapshot caller) — never on a
        dispatcher. A worker's buffer is single-group, so one handle
        lookup covers each batch; concurrent snapshots are safe (popleft
        is atomic, each batch is ingested exactly once)."""
        pending = self._tel_pending
        tracer = self.telemetry.tracer
        while True:
            try:
                epoch_idx, recs = pending.popleft()
            except IndexError:
                break
            chunks, items, host_h, dev_h = self._tel_handles(
                recs[0].token.group)
            n = 0
            for rec in recs:
                n += rec.token.chunk.size
                host = (rec.tc2 - rec.tc1) + (max(rec.tc3 - rec.tg5, 0.0)
                                              if rec.tg5 > 0.0
                                              else max(rec.tc3 - rec.tc2,
                                                       0.0))
                host_h.observe(host)
                # the timed phases' device seconds where the executor has
                # them: Tg5 − Tg1 holds the next chunk's run at depth ≥ 2
                dev = part_device_s(rec)
                dev_h.observe(rec.device_time if dev is None else dev)
                tracer.chunk(rec, epoch_idx)
            chunks.add(len(recs))
            items.add(n)
        if self._tel_lost:
            self.telemetry.registry.gauge("sched.observe_lost_batches") \
                .set(self._tel_lost)

    def _mark_failed(self, name: str,
                     epoch: Optional[EpochHandle] = None) -> None:
        """In-band group death: exclude it from this and all later epochs.
        ``epoch`` is None when death is declared outside any epoch (the
        dispatcher guard caught an escape between epochs)."""
        with self._cv:
            self._failed.append(name)
            if epoch is not None:
                epoch._failed.append(name)
            self.specs.pop(name, None)
            self.executors.pop(name, None)
            if self.partitioner is not None:
                self.partitioner.remove_group(name)
            self._cv.notify_all()
        if self.telemetry is not None:
            self.telemetry.registry.counter("sched.group_failures",
                                            group=name).add()
            self.telemetry.tracer.instant(
                "group_failed", tid="events", group=name,
                epoch=epoch.index if epoch is not None else -1)

    def _leave_epoch(self, name: str, epoch: EpochHandle) -> None:
        with self._cv:
            self._worker_pos[name] = epoch.index + 1
            self._maybe_finalize_locked(epoch)
            self._prune_epochs_locked()
            self._recompute_preempt_locked()
            self._cv.notify_all()

    def _retire_worker(self, name: str) -> None:
        with self._cv:
            self._worker_pos.pop(name, None)
            if name not in self.specs:      # died/removed, not shutdown
                self._threads.pop(name, None)
            for h in self._epochs:
                if not h.finalized:
                    self._maybe_finalize_locked(h)
            self._prune_epochs_locked()
            self._recompute_preempt_locked()
            self._cv.notify_all()

    # -- epoch finalization --------------------------------------------
    def _maybe_finalize_locked(self, epoch: EpochHandle) -> None:
        if epoch.finalized:
            return
        if self._worker_pos and not epoch.cancelled \
                and (epoch.space.remaining > 0
                     or (self.partitioner is not None
                         and self.partitioner.has_work(epoch.space))):
            # Work is still reachable: a failure requeued items into the
            # space, or (range mode) a preempted dispatcher left its
            # claimed-but-unconsumed private range behind — invisible to
            # ``space.remaining`` but found by ``has_work``, the same
            # test _best_open_locked routes idle dispatchers with. A
            # live dispatcher will scan back and drain it (see
            # _await_epoch). A cancelled epoch finalizes *with* its
            # unfinished tail — that tail is the caller's to requeue,
            # not the dispatchers'.
            return
        if all(pos > epoch.index for pos in self._worker_pos.values()):
            self._finalize_epoch_locked(epoch)

    def _prune_epochs_locked(self) -> None:
        """Drop finalized leading epochs every worker is already past —
        keeps the epoch window (and its record lists) bounded on a
        long-running daemon."""
        min_pos = min(self._worker_pos.values(), default=None)
        while self._epochs and self._epochs[0].finalized \
                and (min_pos is None or min_pos > self._epochs[0].index):
            self._epochs.popleft()
            self._epoch_base += 1

    def _finalize_epoch_locked(self, h: EpochHandle) -> None:
        h.finished_at = self.clock()
        t0 = h.started_at if h.started_at is not None else h.submitted_at
        total = max(h.finished_at - t0, 0.0)
        per_items: Dict[str, int] = {}
        for r in h._records:
            per_items[r.token.group] = per_items.get(r.token.group, 0) \
                + r.token.chunk.size
        overheads = {g: h.ledger.report(total, g)
                     for g in h.ledger.groups()}
        overheads["all"] = h.ledger.report(total)
        # beside the Tg stamps' terms: those the timed phases measure
        for g, f in phase_fractions(h._records, total).items():
            overheads.setdefault(g, {}).update(f)
        h._result = ScheduleResult(
            total_time=total,
            iterations=sum(per_items.values()),
            records=list(h._records),
            overheads=overheads,
            throughput=self.tracker.snapshot(),
            per_group_items=per_items,
            failed_groups=list(h._failed),
            cancelled=h.cancelled,
            cancel_reason=h.cancel_reason or "",
            unfinished=h.space.remaining,
        )
        h._event.set()
        with h._cb_lock:
            cbs, h._callbacks = h._callbacks, []
        for fn in cbs:
            fn(h)
        if self.telemetry is not None:
            self.telemetry.registry.counter("sched.epochs_finalized").add()
            self.telemetry.tracer.span(
                f"epoch:{h.index}", "epochs", t0, h.finished_at,
                epoch=h.index, iterations=h._result.iterations,
                groups=list(per_items), tier=h.priority,
                cancelled=h.cancelled)

    # -- live observability --------------------------------------------
    def telemetry_snapshot(self) -> Optional[Dict]:
        """Merged metrics snapshot plus the partitioner's lock-contention
        stats — the ``runtime.telemetry_snapshot()`` live-introspection
        API (None when built with ``telemetry=repro_torch.telemetry.OFF``)."""
        if self.telemetry is None:
            return None
        snap = self.telemetry.snapshot()
        if self.partitioner is not None:
            snap["contention"] = self.partitioner.contention_stats()
        return snap
