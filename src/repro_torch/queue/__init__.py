"""Job queue & admission control feeding the dynamic scheduler.

The §3.1 pipeline schedules work it is handed; this package is the layer
in front of it for a scheduling *service*: admission (backpressure against
a queue-delay SLO), prioritization (thread-safe heap), durability
(append-only JSONL journal with crash recovery), and a daemon loop that
drains admitted jobs into DynamicScheduler runs and requeues work lost to
group failures.
"""
from repro_torch.queue.job import (TERMINAL, TRANSITIONS, IllegalTransition, Job,
                             JobState)
from repro_torch.queue.manager import EXPRESS_RANK, QueueManager
from repro_torch.queue.admission import (AdmissionController, AdmissionDecision,
                                   Decision)
from repro_torch.queue.journal import JournalStore
from repro_torch.queue.service import (BatchReport, JobService, ServiceStats,
                                 percentiles)

__all__ = [
    "TERMINAL", "TRANSITIONS", "IllegalTransition", "Job", "JobState",
    "EXPRESS_RANK", "QueueManager",
    "AdmissionController", "AdmissionDecision", "Decision",
    "JournalStore", "BatchReport", "JobService", "ServiceStats",
    "percentiles",
]
