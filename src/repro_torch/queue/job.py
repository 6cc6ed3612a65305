"""Job model and lifecycle state machine for the admission/queue layer.

A Job is the unit of *admission*: a contiguous slab of ``items`` iterations
(requests, samples) that enters the system with a priority and flows

    PENDING → ADMITTED → RUNNING → {DONE, FAILED, REQUEUED, CANCELLED}
                 ↑______________________________|
                        (REQUEUED → ADMITTED)

Transitions are validated — an illegal transition raises IllegalTransition
rather than silently corrupting queue accounting (the GPUScheduler lesson:
state drift between heap and store is the classic queue bug). Each
transition stamps the timestamp the metric layer needs (queue delay is
``started_at − created_at``; service time is ``finished_at − started_at``).
"""
from __future__ import annotations

import json
import time
import uuid
from dataclasses import asdict, dataclass, field
from enum import Enum
from typing import Any, Dict, Optional

from repro_torch.core.types import TIERS, tier_rank


def now() -> float:
    """Wall-clock source for every job lifecycle stamp. Module-level so
    the deterministic test harness (tests/clock.py) can substitute a
    virtual clock (``repro_torch.queue.job.now = vclock.now``) and make queue
    delays / deadlines exact instead of sleep-raced."""
    return time.time()


class JobState(str, Enum):
    PENDING = "pending"        # submitted, awaiting admission decision
    ADMITTED = "admitted"      # accepted, sitting in the priority queue
    RUNNING = "running"        # drained into a DynamicScheduler run
    DONE = "done"              # all items completed
    FAILED = "failed"          # exhausted attempts / rejected fatally
    REQUEUED = "requeued"      # failed in-flight, eligible for re-admission
    CANCELLED = "cancelled"    # withdrawn by caller or rejected at admission


#: legal state graph; anything not listed raises IllegalTransition.
TRANSITIONS: Dict[JobState, frozenset] = {
    JobState.PENDING: frozenset({JobState.ADMITTED, JobState.FAILED,
                                 JobState.CANCELLED}),
    JobState.ADMITTED: frozenset({JobState.RUNNING, JobState.CANCELLED}),
    JobState.RUNNING: frozenset({JobState.DONE, JobState.FAILED,
                                 JobState.REQUEUED, JobState.CANCELLED}),
    JobState.REQUEUED: frozenset({JobState.ADMITTED, JobState.FAILED,
                                  JobState.CANCELLED}),
    JobState.DONE: frozenset(),
    JobState.FAILED: frozenset(),
    JobState.CANCELLED: frozenset(),
}

TERMINAL = frozenset({JobState.DONE, JobState.FAILED, JobState.CANCELLED})


class IllegalTransition(ValueError):
    """Raised on a state change the lifecycle graph does not allow."""


@dataclass
class Job:
    """One admitted slab of work: ``items`` iterations at ``priority``.

    Lower ``priority`` is more urgent (heap order); ties break FIFO on the
    queue's admission sequence number, not on wall-clock, so two jobs
    admitted in the same clock tick still have a deterministic order.

    ``tier`` is the latency class (core.types.TIERS): it orders the heap
    *above* ``priority`` (any urgent job beats any standard job), selects
    the express lane in the service, and sets the epoch priority its
    batch runs at. ``deadline_s`` is a relative latency budget from
    ``created_at``; a job past ``deadline_at`` is shed at admission or
    pop, and an in-flight batch past it is cancelled cooperatively.
    """
    items: int = 1
    priority: int = 10
    tier: str = "standard"
    deadline_s: Optional[float] = None
    job_id: str = field(default_factory=lambda: uuid.uuid4().hex)
    tenant: str = "default"
    state: JobState = JobState.PENDING
    created_at: float = field(default_factory=lambda: now())
    admitted_at: Optional[float] = None
    started_at: Optional[float] = None        # latest dispatch
    first_started_at: Optional[float] = None  # first dispatch (SLO metric)
    finished_at: Optional[float] = None
    attempts: int = 0
    max_attempts: int = 3
    meta: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.items <= 0:
            raise ValueError(f"job {self.job_id}: items must be > 0")
        if not self.tenant:
            # the tenant is a routing key (queue shard, DWRR weight,
            # accounting bucket) — an empty one would silently create a
            # phantom shard
            raise ValueError(f"job {self.job_id}: tenant must be non-empty")
        if isinstance(self.state, str) and not isinstance(self.state,
                                                          JobState):
            self.state = JobState(self.state)
        tier_rank(self.tier)    # unknown tier names fail at submission
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(f"job {self.job_id}: deadline_s must be > 0")

    # -- lifecycle -----------------------------------------------------
    def transition(self, new: JobState) -> "Job":
        if new not in TRANSITIONS[self.state]:
            raise IllegalTransition(
                f"job {self.job_id}: {self.state.value} -> {new.value}")
        t = now()
        if new == JobState.ADMITTED:
            self.admitted_at = t
        elif new == JobState.RUNNING:
            self.started_at = t
            if self.first_started_at is None:
                self.first_started_at = t
            self.attempts += 1
        elif new in TERMINAL or new == JobState.REQUEUED:
            self.finished_at = t
        self.state = new
        return self

    @property
    def rank(self) -> int:
        """Tier comparison key (lower = more urgent)."""
        return tier_rank(self.tier)

    @property
    def deadline_at(self) -> Optional[float]:
        """Absolute deadline on the job clock, or None (no deadline)."""
        if self.deadline_s is None:
            return None
        return self.created_at + self.deadline_s

    @property
    def terminal(self) -> bool:
        return self.state in TERMINAL

    @property
    def queue_delay(self) -> Optional[float]:
        """Submission-to-first-dispatch latency (the SLO the admission
        controller protects). Uses the *first* dispatch so a requeued
        job's earlier service time does not inflate the queue metric."""
        if self.first_started_at is None:
            return None
        return self.first_started_at - self.created_at

    @property
    def attempts_left(self) -> int:
        return max(0, self.max_attempts - self.attempts)

    # -- serialization (journal lines) ---------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d = asdict(self)
        d["state"] = self.state.value
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Job":
        job = cls(items=int(d.get("items", 1)),
                  priority=int(d.get("priority", 10)),
                  tier=d.get("tier", "standard"),
                  deadline_s=d.get("deadline_s"),
                  job_id=d.get("job_id", uuid.uuid4().hex),
                  tenant=d.get("tenant", "default"),
                  state=JobState(d.get("state", "pending")),
                  created_at=float(d.get("created_at", time.time())),
                  admitted_at=d.get("admitted_at"),
                  started_at=d.get("started_at"),
                  first_started_at=d.get("first_started_at"),
                  finished_at=d.get("finished_at"),
                  attempts=int(d.get("attempts", 0)),
                  max_attempts=int(d.get("max_attempts", 3)),
                  meta=dict(d.get("meta") or {}))
        return job

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Job":
        return cls.from_dict(json.loads(s))
