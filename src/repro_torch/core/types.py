"""Core scheduler datatypes (paper §3.1).

The paper's iteration space is a [begin, end) range of parallel-loop
iterations; chunks are sub-ranges. Tokens mirror the paper's G_token/C_token:
a chunk tagged with the device(-group) that will process it.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional, Tuple


class DeviceKind(str, Enum):
    ACCEL = "accel"     # the paper's GPU: gets the tuned chunk G
    BIG = "big"         # the paper's CPU core / A15: λ-proportional chunks
    LITTLE = "little"   # the paper's A7


#: Latency tiers, best-first. An epoch's (or job's) tier decides queue
#: order everywhere a choice exists: the scheduler's epoch queue, the
#: per-tenant job heaps, and the service's express lane. Rank is the
#: comparison key (lower = more urgent).
TIERS = ("urgent", "standard", "batch")
TIER_RANK = {t: i for i, t in enumerate(TIERS)}


def tier_rank(tier: str) -> int:
    """Rank for a tier name; raises on unknown tiers so a typo'd job spec
    fails at submission, not as a silently mid-priority job."""
    try:
        return TIER_RANK[tier]
    except KeyError:
        raise ValueError(f"unknown tier {tier!r}; expected one of {TIERS}") \
            from None


@dataclass(frozen=True)
class Chunk:
    """A [begin, end) sub-range of the iteration space."""
    begin: int
    end: int
    seq: int = 0                      # monotonically increasing chunk id

    @property
    def size(self) -> int:
        return self.end - self.begin

    def __post_init__(self):
        if self.end < self.begin:
            raise ValueError(f"bad chunk [{self.begin}, {self.end})")


@dataclass(frozen=True)
class Token:
    """G_token / C_token: a chunk routed to a device group."""
    chunk: Chunk
    group: str                        # device-group name
    kind: DeviceKind

    @property
    def is_accel(self) -> bool:
        return self.kind == DeviceKind.ACCEL


@dataclass
class ChunkRecord:
    """Completion record for one processed chunk, with the paper's timestamps.

    Host side  (TBB tick_count analogues):  Tc1 Filter₁ entry, Tc2 submit
    complete (work enqueued on the device), Tc3 host resumed after completion.
    Device side (OpenCL profile analogues): Tg1 transfer-in start, Tg2 kernel
    launch, Tg3 kernel start, Tg4 kernel end / transfer-out start, Tg5 done.
    """
    token: Token
    tc1: float = 0.0
    tc2: float = 0.0
    tc3: float = 0.0
    tg1: float = 0.0
    tg2: float = 0.0
    tg3: float = 0.0
    tg4: float = 0.0
    tg5: float = 0.0
    ok: bool = True
    meta: Dict[str, Any] = field(default_factory=dict)

    @property
    def device_time(self) -> float:
        return self.tg5 - self.tg1

    @property
    def wall_time(self) -> float:
        return self.tc3 - self.tc1

    @property
    def throughput(self) -> float:
        """Effective λ = chunk/T — the paper's eqs (1)–(2); includes transfer
        and launch time, as the paper does (footnote 1)."""
        t = self.device_time if self.device_time > 0 else self.wall_time
        return self.token.chunk.size / max(t, 1e-12)


@dataclass
class GroupSpec:
    """A schedulable device group (the paper's 'computing device')."""
    name: str
    kind: DeviceKind
    # ACCEL groups use a fixed tuned chunk G; others are λ-proportional.
    fixed_chunk: Optional[int] = None
    min_chunk: int = 1                # TBB's ≥100k-cycles guidance analogue
    max_chunk: Optional[int] = None
    init_throughput: float = 1.0      # λ seed before first measurement
    meta: Dict[str, Any] = field(default_factory=dict)


class IterationSpace:
    """Thread-compatible remaining-range tracker (Filter₁'s shared state)."""

    def __init__(self, begin: int, end: int):
        self.begin0, self.end0 = begin, end
        self._next = begin
        self._end = end
        self._seq = itertools.count()

    @property
    def remaining(self) -> int:
        return self._end - self._next

    def next_seq(self) -> int:
        """Mint the next chunk sequence number. Atomic without a lock
        (itertools.count under the GIL), so the partitioner's range-mode
        fast path can tag chunks it carves out of a pre-assigned range
        without touching shared state."""
        return next(self._seq)

    def take(self, n: int) -> Optional[Chunk]:
        if self._next >= self._end:
            return None
        n = max(1, min(n, self._end - self._next))
        c = Chunk(self._next, self._next + n, next(self._seq))
        self._next += n
        return c

    def put_back(self, chunk: Chunk) -> None:
        """Re-queue a failed chunk (fault tolerance). Only supports returning
        the most recently taken trailing range or re-execution bookkeeping —
        we model re-execution by extending the end (work conservation is on
        iteration COUNT, asserted by tests)."""
        self._end += chunk.size
