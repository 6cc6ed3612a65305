"""Wait-instrumented locking shared by the hot-path components.

``TimedLock`` is a plain ``threading.Lock`` that accumulates the time
callers spend *waiting* to acquire it — the lock-wait metric
benchmarks/dispatch_overhead.py and ``contention_stats()`` report. Two
clock reads per acquire; components keep it off their fast paths and pay
it only on slow paths (range refills, tracker cell registration), so the
instrumentation itself never becomes the contention it measures.
"""
from __future__ import annotations

import threading
import time

clock = time.monotonic


class TimedLock:
    """threading.Lock accumulating acquire-wait time."""

    __slots__ = ("_lock", "wait_s", "acquires")

    def __init__(self):
        self._lock = threading.Lock()
        self.wait_s = 0.0
        self.acquires = 0

    def __enter__(self) -> "TimedLock":
        t0 = clock()
        self._lock.acquire()
        # mutated under the lock just acquired: no torn updates
        self.wait_s += clock() - t0
        self.acquires += 1
        return self

    def __exit__(self, *exc) -> None:
        self._lock.release()

    def stats(self) -> dict:
        """``{lock_wait_s, lock_acquires}`` read under the raw lock so the
        pair comes from one acquire (no torn snapshot) without the timed
        wrapper charging the read itself to ``wait_s``."""
        with self._lock:
            return {"lock_wait_s": self.wait_s,
                    "lock_acquires": float(self.acquires)}
