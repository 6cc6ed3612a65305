"""Failure detection beyond in-band ChunkFailure: a watchdog that treats
chunk completions as heartbeats and declares a group dead when it has an
outstanding chunk for longer than ``timeout × expected_chunk_time``.

In-band failures (the executor raising ChunkFailure) are already handled by
DynamicScheduler (requeue + group removal); the watchdog covers *hangs* —
the failure mode in-band exceptions cannot see.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.core.throughput import ThroughputTracker


@dataclass
class GroupHealth:
    last_heartbeat: float
    outstanding_since: Optional[float] = None
    expected_s: float = 1.0
    dead: bool = False


class Watchdog:
    def __init__(self, tracker: ThroughputTracker,
                 timeout_factor: float = 5.0, min_timeout_s: float = 2.0,
                 on_dead: Optional[Callable[[str], None]] = None,
                 clock=None):
        self.tracker = tracker
        self.timeout_factor = timeout_factor
        self.min_timeout_s = min_timeout_s
        self.on_dead = on_dead
        # injectable monotonic clock (tests/clock.py VirtualClock)
        self.clock = clock if clock is not None else time.monotonic
        self._health: Dict[str, GroupHealth] = {}
        self._lock = threading.Lock()

    def chunk_started(self, group: str, expected_items: float):
        lam = self.tracker.get(group)
        with self._lock:
            h = self._health.setdefault(group, GroupHealth(self.clock()))
            h.outstanding_since = self.clock()
            h.expected_s = expected_items / max(lam, 1e-9)

    def chunk_finished(self, group: str):
        with self._lock:
            h = self._health.setdefault(group, GroupHealth(self.clock()))
            h.last_heartbeat = self.clock()
            h.outstanding_since = None

    def revive(self, group: str) -> None:
        """Forget a group's dead verdict (its runtime was rebuilt from
        the factory). The dead flag is sticky by design — check() must
        not re-report a hang every poll — so a rebuild that brings the
        same group names back must clear it, or the fresh group would be
        condemned by its predecessor's hang."""
        with self._lock:
            self._health.pop(group, None)

    def check(self) -> List[str]:
        """Returns groups newly declared dead."""
        now = self.clock()
        newly = []
        with self._lock:
            for g, h in self._health.items():
                if h.dead or h.outstanding_since is None:
                    continue
                limit = max(self.min_timeout_s,
                            self.timeout_factor * h.expected_s)
                if now - h.outstanding_since > limit:
                    h.dead = True
                    newly.append(g)
        for g in newly:
            if self.on_dead:
                self.on_dead(g)
        return newly
