"""Straggler detection & mitigation.

Mitigation is *native* to the paper's partitioner: a slowing group's λ-EWMA
drops, so eq. (4) automatically hands it smaller chunks — it starves itself
of work instead of stalling the fleet. This module adds detection/reporting
on top (for operators and for quarantine decisions), normalizing each group's
current λ by its own healthy baseline so heterogeneity (a LITTLE group being
slower than a BIG group) is not misread as straggling.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.throughput import ThroughputTracker
from repro_torch.policy.window import SlidingWindow


@dataclass
class StragglerReport:
    group: str
    current: float
    baseline: float

    @property
    def slowdown(self) -> float:
        return self.current / self.baseline if self.baseline else 1.0


class StragglerDetector:
    """Reports groups whose current λ fell below ``threshold`` × their
    healthy baseline.

    ``window_s=None`` (default) keeps the original running-max baseline:
    a group's best-ever λ, never forgotten. With a window, the baseline
    is the max λ observed within the last ``window_s`` seconds
    (``repro_torch.policy.SlidingWindow``), so a *persistent* slowdown becomes
    the new normal after one horizon and the group stops being reported
    — derates decay instead of pinning a permanently-derated group to a
    stale best-case baseline."""

    def __init__(self, tracker: ThroughputTracker,
                 threshold: float = 0.5, warmup_chunks: int = 3,
                 window_s: Optional[float] = None, clock=None):
        self.tracker = tracker
        self.threshold = threshold
        self.warmup = warmup_chunks
        self.window_s = window_s
        self.clock = clock if clock is not None else time.monotonic
        self._baseline: Dict[str, float] = {}
        self._windows: Dict[str, SlidingWindow] = {}

    def _windowed_baseline(self, g: str, lam: float) -> float:
        w = self._windows.get(g)
        if w is None:
            w = self._windows[g] = SlidingWindow(self.window_s)
        now = self.clock()
        w.observe(now, lam)
        return w.max(now)

    def observe(self) -> List[StragglerReport]:
        out = []
        for g, lam in self.tracker.snapshot().items():
            st = self.tracker.stats(g)
            if st is None or st.n < self.warmup:
                continue
            if self.window_s is not None:
                base = self._windowed_baseline(g, lam)
            else:
                base = self._baseline.get(g)
                if base is None or lam > base:
                    self._baseline[g] = base = lam
            if lam < self.threshold * base:
                out.append(StragglerReport(g, lam, base))
        return out
