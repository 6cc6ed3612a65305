"""ChaosInjector: the runtime half of the fault plane.

One injector instance is shared by every hook in a run. It owns the
plan's clock origin (``start()``), answers "is fault X active / due for
target Y" queries, consumes one-shot events exactly once, and counts
every injection under ``chaos.injected{layer,kind}`` so a soak's metrics
feed shows exactly which faults actually fired.

Hooks shipped here:

  * ``ChaosExecutor`` — a ChunkExecutor decorator injecting executor
    faults (chunk_exception → in-band ChunkFailure, hang → a sleep long
    enough to trip the Watchdog, slowdown → added per-chunk latency).
    It also heartbeats an attached Watchdog around every chunk — the
    wiring that makes hang detection live on any executor, not just the
    hand-written drill.
  * ``ChaosSink`` — a ReplicaSink decorator that fails mirror writes
    while a ``mirror_fail`` window is active (the journal detaches; the
    federation's gossip loop re-syncs when the window passes).
  * ``journal_write_filter`` — JournalStore write hook corrupting or
    stalling the next primary record (the mirror always gets the true
    line: chaos models a bad local disk, not a bad wire).
  * ``skewed_clock`` / ``wrap_queue`` — queue-layer faults: admission
    clock skew and swallowed arrival notifications (the drain's
    fallback timeout is the liveness backstop under test).

Every query is cheap (a scan over a small event list under one lock);
the hot executor path only pays it per *chunk*, not per item.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch import telemetry as telemetry_mod
from repro_torch.chaos.plan import FaultEvent, FaultPlan
from repro_torch.core.dispatch import ChunkFailure
from repro_torch.core.types import ChunkRecord, Token


class ChaosInjector:
    def __init__(self, plan: FaultPlan, clock=None, sleep=None,
                 telemetry=None):
        self.plan = plan
        self.clock = clock if clock is not None else time.monotonic
        self._sleep = sleep if sleep is not None else time.sleep
        self.telemetry = telemetry_mod.resolve(telemetry)
        self._lock = threading.Lock()
        self._events: List[Tuple[int, FaultEvent]] = \
            list(enumerate(plan.events))
        self._consumed: set = set()      # one-shot event ids fired
        self._seen: set = set()          # window event ids counted once
        self._t0: Optional[float] = None
        self.injected = 0                # total injections (tests)

    # -- lifecycle -----------------------------------------------------
    def start(self, now: Optional[float] = None) -> None:
        with self._lock:
            if self._t0 is None:
                self._t0 = self.clock() if now is None else now

    def started(self) -> bool:
        return self._t0 is not None

    def now_s(self) -> float:
        """Seconds since start() (0.0 before it — no fault fires until
        the harness opens the window)."""
        if self._t0 is None:
            return 0.0
        return self.clock() - self._t0

    def done(self) -> bool:
        """Past the horizon with every one-shot consumed or expired."""
        return self.started() and self.now_s() >= self.plan.horizon_s

    # -- queries -------------------------------------------------------
    def active(self, layer: str, kind: str,
               target: Optional[str] = None) -> Optional[FaultEvent]:
        """The first *windowed* event of (layer, kind) covering now and
        matching target, or None. Counted once per event."""
        if self._t0 is None:
            return None
        t = self.now_s()
        with self._lock:
            for idx, ev in self._events:
                if ev.layer != layer or ev.kind != kind \
                        or ev.duration_s <= 0.0:
                    continue
                if ev.at_s <= t < ev.end_s and ev.matches(target):
                    if idx not in self._seen:
                        self._seen.add(idx)
                        self._count(ev)
                    return ev
        return None

    def take(self, layer: str, kind: str,
             target: Optional[str] = None) -> Optional[FaultEvent]:
        """Consume one due *one-shot* event of (layer, kind) for target.
        Exactly-once: the first hook to observe it due gets it."""
        if self._t0 is None:
            return None
        t = self.now_s()
        with self._lock:
            for idx, ev in self._events:
                if ev.layer != layer or ev.kind != kind \
                        or ev.duration_s > 0.0 or idx in self._consumed:
                    continue
                if ev.at_s <= t and ev.matches(target):
                    self._consumed.add(idx)
                    self._count(ev)
                    return ev
        return None

    def take_kills(self, alive: Sequence[str]) -> List[str]:
        """Due, unconsumed kill events whose target is still alive."""
        out = []
        for rid in alive:
            if self.take("federation", "kill", rid) is not None:
                out.append(rid)
        return out

    def _count(self, ev: FaultEvent) -> None:
        self.injected += 1
        if self.telemetry is not None:
            self.telemetry.registry.counter(
                "chaos.injected", layer=ev.layer, kind=ev.kind).add(1)
            self.telemetry.tracer.instant(
                "chaos", tid="chaos", layer=ev.layer, kind=ev.kind,
                target=ev.target, at_s=ev.at_s)

    # -- queue-layer hooks ---------------------------------------------
    def skewed_clock(self, target: str, base=None) -> Callable[[], float]:
        """A clock that reads ``base()`` plus the magnitude of any
        active clock_skew window for ``target`` — hand it to an
        AdmissionController to skew its deadline/delay arithmetic."""
        base = base if base is not None else time.monotonic

        def clk() -> float:
            t = base()
            ev = self.active("queue", "clock_skew", target)
            return t + ev.magnitude if ev is not None else t
        return clk

    def wrap_queue(self, queue, target: str):
        """Decorate ``queue.add_listener`` so listeners registered after
        this call silently drop notifications while a listener_drop
        window is active (the drain's fallback timeout must cover)."""
        orig_add = getattr(queue, "add_listener", None)
        if orig_add is None:
            return queue
        inj = self

        def add_listener(fn):
            def guarded(*a, **k):
                if inj.active("queue", "listener_drop", target) is not None:
                    return None
                return fn(*a, **k)
            orig_add(guarded)
        queue.add_listener = add_listener
        return queue

    # -- journal-layer hook ----------------------------------------------
    def journal_write_filter(self, rid: str) \
            -> Callable[[str], Optional[str]]:
        """JournalStore write hook: stalls or corrupts the next primary
        record when a due journal fault targets ``rid``. Returns the
        exact string to write (None → unmodified ``line + "\\n"``); the
        mirror always receives the true line."""

        def filt(line: str) -> Optional[str]:
            ev = self.take("journal", "fsync_stall", rid)
            if ev is not None and ev.magnitude > 0.0:
                self._sleep(ev.magnitude)
            ev = self.take("journal", "corrupt_record", rid)
            if ev is not None:
                mid = len(line) // 2
                return line[:mid] + "#CHAOS#" + line[mid:] + "\n"
            return None
        return filt


class ChaosExecutor:
    """ChunkExecutor decorator: executor-layer faults + Watchdog wiring.

    Faults fire at chunk granularity on the owning dispatcher thread:
    ``chunk_exception`` raises in-band ChunkFailure (the scheduler's
    requeue + group-removal path), ``hang`` sleeps ``magnitude`` seconds
    before executing — long enough that an attached Watchdog times the
    group out mid-sleep (the chunk still completes afterwards, so no
    items are lost; the group is simply declared dead while wedged) — and
    ``slowdown`` adds ``magnitude`` seconds per chunk inside its window.

    When a ``watchdog`` is attached, every chunk is bracketed by
    ``chunk_started`` / ``chunk_finished`` — the heartbeat feed
    fault_tolerance.Watchdog needs, previously wired only in tests.
    """

    def __init__(self, inner, group: str, injector: ChaosInjector,
                 watchdog=None, sleep=None):
        self.inner = inner
        self.group = group
        self.injector = injector
        self.watchdog = watchdog
        self._sleep = sleep if sleep is not None else time.sleep

    # pass-throughs ----------------------------------------------------
    def on_worker_start(self) -> None:
        self.inner.on_worker_start()

    def drain(self):
        return self.inner.drain()

    def cancel(self):
        return self.inner.cancel()

    def abort(self):
        return self.inner.abort()

    def completed(self):
        return self.inner.completed()

    # fault-injecting execute ------------------------------------------
    def execute(self, token: Token, rec: ChunkRecord):
        inj = self.injector
        ev = inj.take("executor", "chunk_exception", self.group)
        if ev is not None:
            raise ChunkFailure(
                f"chaos: injected chunk exception on {self.group}")
        if self.watchdog is not None:
            self.watchdog.chunk_started(self.group, token.chunk.size)
        ev = inj.take("executor", "hang", self.group)
        if ev is not None and ev.magnitude > 0.0:
            self._sleep(ev.magnitude)
        ev = inj.active("executor", "slowdown", self.group)
        if ev is not None and ev.magnitude > 0.0:
            self._sleep(ev.magnitude)
        done = self.inner.execute(token, rec)
        if self.watchdog is not None:
            self.watchdog.chunk_finished(self.group)
        return done


class ChaosSink:
    """ReplicaSink decorator failing writes during mirror_fail windows.
    The journal detaches on the raised error (its contract for any bad
    sink); the federation heals by re-syncing once the window passes."""

    def __init__(self, inner, rid: str, injector: ChaosInjector):
        self.inner = inner
        self.rid = rid
        self.injector = injector
        self.path = getattr(inner, "path", None)

    def _gate(self) -> None:
        ev = self.injector.active("federation", "mirror_fail", self.rid)
        if ev is not None:
            raise OSError(
                f"chaos: mirror write failure for {self.rid}")

    def append(self, line: str) -> None:
        self._gate()
        self.inner.append(line)

    def rewrite(self, lines) -> None:
        self._gate()
        self.inner.rewrite(lines)

    def close(self) -> None:
        self.inner.close()
