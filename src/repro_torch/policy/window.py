"""Sliding-window statistics over timestamped samples.

``SlidingWindow`` keeps a bounded deque of ``(t, v)`` pairs, evicting
samples older than ``horizon_s`` on every observation and read, plus a
running EWMA that survives eviction (the EWMA summarizes *all* history
with exponential decay; the window bounds the quantile/extreme views to
recent behavior). All methods are O(window) worst case with a hard
``max_samples`` cap so a traffic spike cannot grow memory unboundedly.

Not thread-safe by itself — every consumer in this repo already
serializes its observations (admission under ``_admit_lock``, straggler
observation on the monitor thread), so the window stays lock-free.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Optional, Tuple


class SlidingWindow:
    def __init__(self, horizon_s: float = 5.0, alpha: float = 0.3,
                 max_samples: int = 256):
        assert horizon_s > 0.0
        assert 0.0 < alpha <= 1.0
        assert max_samples >= 1
        self.horizon_s = horizon_s
        self.alpha = alpha
        self._buf: Deque[Tuple[float, float]] = deque(maxlen=max_samples)
        self._ewma: Optional[float] = None
        self._last: Optional[float] = None

    def observe(self, t: float, v: float) -> None:
        self._evict(t)
        self._buf.append((t, v))
        self._last = v
        self._ewma = v if self._ewma is None else \
            self.alpha * v + (1 - self.alpha) * self._ewma

    def _evict(self, now: float) -> None:
        cutoff = now - self.horizon_s
        buf = self._buf
        while buf and buf[0][0] < cutoff:
            buf.popleft()

    # -- reads ---------------------------------------------------------
    @property
    def count(self) -> int:
        return len(self._buf)

    @property
    def ewma(self) -> float:
        return 0.0 if self._ewma is None else self._ewma

    @property
    def last(self) -> float:
        return 0.0 if self._last is None else self._last

    def values(self, now: Optional[float] = None):
        if now is not None:
            self._evict(now)
        return [v for _, v in self._buf]

    def mean(self, now: Optional[float] = None) -> float:
        vs = self.values(now)
        return sum(vs) / len(vs) if vs else 0.0

    def min(self, now: Optional[float] = None) -> float:
        vs = self.values(now)
        return min(vs) if vs else 0.0

    def max(self, now: Optional[float] = None) -> float:
        vs = self.values(now)
        return max(vs) if vs else 0.0

    def quantile(self, q: float, now: Optional[float] = None) -> float:
        """Nearest-rank quantile of the windowed samples (0 when empty).
        Guaranteed within [window min, window max] for any q in [0, 1]."""
        assert 0.0 <= q <= 1.0
        vs = sorted(self.values(now))
        if not vs:
            return 0.0
        idx = min(len(vs) - 1, max(0, int(round(q * (len(vs) - 1)))))
        return vs[idx]

    def median(self, now: Optional[float] = None) -> float:
        return self.quantile(0.5, now)

    def span(self, now: Optional[float] = None) -> float:
        """Time covered by the windowed samples (0 with fewer than 2)."""
        if now is not None:
            self._evict(now)
        if len(self._buf) < 2:
            return 0.0
        return self._buf[-1][0] - self._buf[0][0]

    def slope(self, now: Optional[float] = None) -> float:
        """Least-squares slope (value units per second) of the windowed
        samples — the window's trend. 0 with fewer than two samples or
        when every sample shares one timestamp. Least-squares rather
        than endpoint difference: endpoints are exactly the noisiest
        samples, and a gate acting on the trend must not flap with them."""
        if now is not None:
            self._evict(now)
        buf = self._buf
        n = len(buf)
        if n < 2:
            return 0.0
        mt = sum(t for t, _ in buf) / n
        mv = sum(v for _, v in buf) / n
        num = sum((t - mt) * (v - mv) for t, v in buf)
        den = sum((t - mt) ** 2 for t, _ in buf)
        return num / den if den > 0.0 else 0.0
