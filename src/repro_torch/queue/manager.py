"""Thread-safe priority queue over Jobs, feeding the dynamic scheduler.

Heap entries are ``(tier rank, priority, seq, job_id)`` — the latency
tier dominates (any urgent job drains before any standard job, which
drains before any batch job), ``priority`` orders within a tier, and
``seq`` is a monotonically increasing admission counter so equal
priorities drain FIFO and a requeued job re-enters *behind* equal-rank
work admitted while it was running (no starvation of fresh traffic by a
crash-looping job). Cancellation is lazy: the entry stays in the heap and
is skipped at pop() when its job is no longer ADMITTED, which keeps
cancel() O(1). ``pop_express`` pops *only* urgent-tier heads — the
service's express lane, which must never accidentally drag standard work
past the pipeline-depth gate.

Per-group in-flight tracking (``mark_running`` / ``mark_finished``) gives
the admission controller and the watchdog a live view of which groups hold
work, mirroring GPUScheduler's running-by-GPU map.

Terminal jobs are evicted from the live map (their counts survive in
``counts()``), so a long-lived daemon's backlog scans stay O(live jobs)
and memory stays bounded — durability of finished state is the journal's
job, not the queue's.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.types import TIER_RANK
from repro_torch.queue.job import Job, JobState

#: tier ranks at or below this drain through the express lane
EXPRESS_RANK = TIER_RANK["urgent"]


def drain_with_deadline(cond: threading.Condition, pop_many_locked,
                        max_n: int, timeout: Optional[float]) -> List[Job]:
    """Shared blocking loop for batched pops (QueueManager and the
    tenancy ShardedQueueManager): returns as soon as at least one job is
    eligible, and a wakeup that loses the race to another consumer
    consumes the *remaining* budget instead of restarting it. Caller
    must already hold ``cond``'s lock."""
    jobs = pop_many_locked(max_n)
    if jobs or not timeout:
        return jobs
    deadline = time.monotonic() + timeout
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0 or not cond.wait(remaining):
            return pop_many_locked(max_n)
        jobs = pop_many_locked(max_n)
        if jobs:
            return jobs


class QueueManager:
    def __init__(self):
        self._heap: List[Tuple[int, int, int, str]] = []
        self._jobs: Dict[str, Job] = {}
        self._inflight: Dict[str, Set[str]] = {}     # group -> job ids
        self._terminal_counts: Dict[str, int] = {}   # evicted-job history
        self._seq = itertools.count()
        self._lock = threading.RLock()
        self._not_empty = threading.Condition(self._lock)
        # arrival listeners (JobService drain wakeup): fired after every
        # put/requeue, OUTSIDE the queue lock — a listener that acquires
        # its own lock can never deadlock against a concurrent pop
        self._listeners: List = []

    def add_listener(self, fn) -> None:
        """Register ``fn()`` to run after each job arrival (put/requeue).
        Must be cheap and exception-free — typically ``Event.set``."""
        with self._lock:
            self._listeners.append(fn)

    def _evict_if_terminal(self, job: Job) -> None:
        if job.terminal:
            self._jobs.pop(job.job_id, None)
            self._terminal_counts[job.state.value] = \
                self._terminal_counts.get(job.state.value, 0) + 1

    # -- admission side ------------------------------------------------
    def put(self, job: Job) -> None:
        """Enqueue a PENDING or REQUEUED job (transitions it to ADMITTED)."""
        with self._lock:
            if job.state in (JobState.PENDING, JobState.REQUEUED):
                job.transition(JobState.ADMITTED)
            elif job.state != JobState.ADMITTED:
                raise ValueError(
                    f"cannot enqueue job {job.job_id} in state "
                    f"{job.state.value}")
            self._jobs[job.job_id] = job
            heapq.heappush(self._heap, (job.rank, job.priority,
                                        next(self._seq), job.job_id))
            self._not_empty.notify()
            listeners = list(self._listeners)
        for fn in listeners:
            fn()

    def cancel(self, job_id: str) -> bool:
        """Cancel a queued (ADMITTED) job; heap entry removed lazily."""
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None or job.state != JobState.ADMITTED:
                return False
            job.transition(JobState.CANCELLED)
            self._evict_if_terminal(job)
            return True

    # -- scheduler side ------------------------------------------------
    def pop(self, timeout: Optional[float] = None) -> Optional[Job]:
        """Highest-priority ADMITTED job, or None after ``timeout``.

        ``timeout=None`` means non-blocking; the returned job stays
        ADMITTED — the service marks it RUNNING once it is bound to a
        scheduler run (two-phase, so a crash between pop and dispatch is
        recoverable from the journal as a still-queued job).
        """
        with self._not_empty:
            while True:
                job = self._pop_admitted_locked()
                if job is not None:
                    return job
                if not timeout:
                    return None
                if not self._not_empty.wait(timeout):
                    return self._pop_admitted_locked()

    def pop_many(self, max_n: int,
                 timeout: Optional[float] = None) -> List[Job]:
        """Up to ``max_n`` highest-priority ADMITTED jobs in ONE lock
        acquisition — the batched drain. Same blocking contract as
        ``pop`` (``timeout=None`` → non-blocking); returns as soon as at
        least one job is available rather than waiting for a full batch.
        Jobs stay ADMITTED (two-phase pop, see ``pop``)."""
        with self._not_empty:
            return drain_with_deadline(self._not_empty,
                                       self._pop_many_locked, max_n, timeout)

    def _pop_many_locked(self, max_n: int) -> List[Job]:
        jobs: List[Job] = []
        while len(jobs) < max_n:
            job = self._pop_admitted_locked()
            if job is None:
                break
            jobs.append(job)
        return jobs

    def _pop_admitted_locked(self, max_rank: Optional[int] = None) \
            -> Optional[Job]:
        """Pop the best ADMITTED job; with ``max_rank``, only if its tier
        rank is at most that (the heap is rank-first, so a too-lazy head
        means no eligible job exists — nothing is popped)."""
        while self._heap:
            rank, _, _, job_id = self._heap[0]
            job = self._jobs.get(job_id)
            if job is None or job.state != JobState.ADMITTED:
                heapq.heappop(self._heap)       # stale entry
                continue
            if max_rank is not None and rank > max_rank:
                return None
            heapq.heappop(self._heap)
            return job
        return None

    def pop_express(self, max_n: int) -> List[Job]:
        """Up to ``max_n`` *urgent-tier* ADMITTED jobs, non-blocking —
        the service's express lane drain. Jobs stay ADMITTED (two-phase
        pop, see ``pop``)."""
        with self._lock:
            jobs: List[Job] = []
            while len(jobs) < max_n:
                job = self._pop_admitted_locked(max_rank=EXPRESS_RANK)
                if job is None:
                    break
                jobs.append(job)
            return jobs

    def express_backlog(self) -> int:
        """Urgent-tier jobs an express pop could take *now* — scanned
        from the heap, not the job map, because two-phase pop leaves
        already-popped jobs ADMITTED (they are the service's to run, not
        the express lane's)."""
        with self._lock:
            seen = set()
            for rank, _, _, job_id in self._heap:
                if rank > EXPRESS_RANK or job_id in seen:
                    continue
                job = self._jobs.get(job_id)
                if job is not None and job.state == JobState.ADMITTED:
                    seen.add(job_id)
            return len(seen)

    def peek(self) -> Optional[Job]:
        """Best ADMITTED job without removing it (stale heap entries for
        cancelled/evicted jobs are dropped on the way) — the DWRR drain
        needs the head job's cost before deciding to serve it."""
        with self._lock:
            while self._heap:
                _, _, _, job_id = self._heap[0]
                job = self._jobs.get(job_id)
                if job is not None and job.state == JobState.ADMITTED:
                    return job
                heapq.heappop(self._heap)
            return None

    def mark_running(self, job: Job, group: str = "*") -> None:
        with self._lock:
            job.transition(JobState.RUNNING)
            self._inflight.setdefault(group, set()).add(job.job_id)

    def mark_finished(self, job: Job, state: JobState) -> None:
        """Terminal (or REQUEUED) transition + in-flight release."""
        with self._lock:
            job.transition(state)
            for ids in self._inflight.values():
                ids.discard(job.job_id)
            self._evict_if_terminal(job)

    def requeue(self, job: Job) -> None:
        """Put a REQUEUED job back on the heap (→ ADMITTED)."""
        with self._lock:
            if job.state != JobState.REQUEUED:
                raise ValueError(
                    f"requeue expects REQUEUED, got {job.state.value}")
            self.put(job)

    # -- introspection -------------------------------------------------
    def get(self, job_id: str) -> Optional[Job]:
        with self._lock:
            return self._jobs.get(job_id)

    def depth(self) -> int:
        """Number of jobs currently waiting (ADMITTED)."""
        with self._lock:
            return sum(1 for j in self._jobs.values()
                       if j.state == JobState.ADMITTED)

    def backlog_items(self) -> int:
        """Total queued iterations — the admission controller's backlog."""
        with self._lock:
            return sum(j.items for j in self._jobs.values()
                       if j.state == JobState.ADMITTED)

    def inflight(self, group: Optional[str] = None) -> int:
        with self._lock:
            if group is not None:
                return len(self._inflight.get(group, ()))
            return len(set().union(*self._inflight.values())) \
                if self._inflight else 0

    def jobs(self, state: Optional[JobState] = None) -> List[Job]:
        with self._lock:
            if state is None:
                return list(self._jobs.values())
            return [j for j in self._jobs.values() if j.state == state]

    def counts(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self._terminal_counts)
            for j in self._jobs.values():
                out[j.state.value] = out.get(j.state.value, 0) + 1
            return out
