"""Chunk executors: how a device group processes a chunk (Filter₂).

Executors fill the device-side timestamps of ChunkRecord:
  tg1→tg2  host-to-device transfer (pinned host → device, non_blocking)
  tg2→tg3  dispatch / launch (the step's enqueue returning — async on CUDA)
  tg3→tg4  device execution (until outputs are ready)
  tg4→tg5  device-to-host fetch of (small) results/metrics

`async_depth` is the accelerator-idiomatic *Dynamic Pri*: with depth ≥ 2 the next
chunk is dispatched before the previous completes, so the device never waits
for the host thread to be rescheduled (the paper's O_td collapses). Depth 1
reproduces the paper's baseline Dynamic (synchronous clFinish()).

`priority_boost` is the literal paper optimization: raise the host/dispatch
thread's OS priority (best-effort `os.nice`; needs privileges to raise).

A device group of the serving engine or of the trainer (`GroupDef`) runs
on one torch device (`group_devices`) through a `TorchChunkExecutor`; its
chunks are padded to a power-of-two batch bucket (`bucket`).
"""
from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from dataclasses import dataclass
from typing import (Any, Callable, Deque, Dict, List, NamedTuple, Optional,
                    Tuple)

import torch

from repro_torch.core.types import Chunk, ChunkRecord, DeviceKind, Token

clock = time.monotonic


class ChunkFailure(RuntimeError):
    """Raised by an executor when its device group dies mid-chunk."""


def try_boost_priority(delta: int = -10) -> bool:
    """Best-effort SetThreadPriority analogue. Lowering niceness requires
    privileges; returns whether the boost took effect."""
    try:
        os.nice(delta)
        return True
    except (PermissionError, OSError):
        return False


class ChunkExecutor:
    """Interface. execute() may complete earlier in-flight work; drain()
    flushes the pipeline at end-of-epoch.

    Executors are *reused across epochs* on the persistent scheduler
    runtime: on_worker_start() fires once per dispatcher thread (runtime
    lifetime), while drain() has per-epoch semantics — the dispatcher calls
    it when an epoch's space is exhausted so no in-flight work crosses an
    epoch boundary. abort() discards the pipeline after a group death and
    returns the abandoned chunks so the caller can requeue them."""

    def on_worker_start(self) -> None:
        pass

    def execute(self, token: Token, rec: ChunkRecord) -> List[ChunkRecord]:
        raise NotImplementedError

    def drain(self) -> List[ChunkRecord]:
        return []

    def cancel(self) -> List[ChunkRecord]:
        """Cooperative wind-down for epoch cancellation: return whatever
        already finished *without* waiting for the rest of the pipeline —
        still-running chunks stay in flight for ``abort()`` to hand back
        as requeue candidates. Synchronous executors have nothing in
        flight, so the default is a plain drain."""
        return self.drain()

    def abort(self) -> List[Chunk]:
        """Drop any in-flight work; returns the chunks to requeue."""
        return []

    def completed(self) -> List[ChunkRecord]:
        """Records that finished but were not yet returned when a failure
        interrupted execute()/drain(); the dispatcher collects them on the
        failure path so finished work is not discarded with the group."""
        return []


class CallableExecutor(ChunkExecutor):
    """Synchronous executor around fn(token) -> meta dict (or None)."""

    def __init__(self, fn: Callable[[Token], Optional[Dict]],
                 priority_boost: bool = False):
        self.fn = fn
        self.priority_boost = priority_boost
        self.boosted = False

    def on_worker_start(self) -> None:
        if self.priority_boost:
            self.boosted = try_boost_priority()

    def execute(self, token: Token, rec: ChunkRecord) -> List[ChunkRecord]:
        rec.tg1 = rec.tg2 = rec.tg3 = clock()
        meta = self.fn(token)
        rec.tg4 = rec.tg5 = clock()
        if meta:
            rec.meta.update(meta)
        return [rec]


class Phase(NamedTuple):
    """One timed phase of a chunk: its host start (monotonic), its host
    and device seconds, the steps counted in it, and the part of the
    chunk it belongs to (``inputs``, ``step``, ``fetch``, or ``wait``:
    the host or the stream waiting for work queued ahead of it)."""
    name: str
    start: float
    host_s: float
    device_s: float
    steps: int
    part: str


def part_device_s(rec: ChunkRecord, *parts: str) -> Optional[float]:
    """Device seconds of ``rec``'s timed phases (``rec.meta["phases"]``)
    in ``parts``, or of all but the waits without any; None where its
    executor timed none."""
    phases = rec.meta.get("phases")
    if not phases:
        return None
    return sum(p.device_s for p in phases
               if (p.part in parts if parts else p.part != "wait"))


def phase_fractions(records, total_time: float) \
        -> Dict[str, Dict[str, float]]:
    """The offload terms that the timed phases measure soundly, as
    fractions of ``total_time``, per group and ``"all"`` over the records
    that have phases: ``O_dh_dev``, the fetch's own device time, and
    ``kernel_dev_frac``, the step's. ``OverheadLedger`` keeps the Tg
    stamps' O_dh and ``kernel_frac``, which admission reads; at async
    depth ≥ 2 Tg4 → Tg5 holds the next chunk's run."""
    t = max(total_time, 1e-12)
    out: Dict[str, Dict[str, float]] = {}
    for rec in records:
        fetch = part_device_s(rec, "fetch")
        if fetch is None:
            continue
        step = part_device_s(rec, "step")
        for key in (rec.token.group, "all"):
            f = out.setdefault(key, {"O_dh_dev": 0.0, "kernel_dev_frac": 0.0})
            f["O_dh_dev"] += fetch / t
            f["kernel_dev_frac"] += step / t
    return out


class PhaseMarks:
    """Phase boundaries of work on one stream, resolved to floats once the
    work has run.

    ``mark(name)`` ends the open phase and opens ``name``: a host stamp
    and, on CUDA, a timing event recorded on ``stream`` (never inside a
    graph capture). ``close()`` ends the last phase and returns its event.
    Once that event has passed, ``resolve()`` gives each phase as a
    ``Phase``: its device seconds are the elapsed time between its event
    and the next, so consecutive phases split the stream's own timeline,
    idle stretches inside a phase included. On the CPU (``stream`` None)
    the work runs as the host calls it, and the host stamps stand in.
    """

    def __init__(self, stream: Optional[torch.cuda.Stream] = None):
        self.stream = stream
        # (name, part, steps, host stamp, event or None)
        self._marks: List[Tuple[str, str, int, float, Any]] = []

    def _event(self):
        if self.stream is None:
            return None
        event = torch.cuda.Event(enable_timing=True)
        event.record(self.stream)
        return event

    def mark(self, name: str, part: str = "step", steps: int = 0,
             sync: bool = False) -> None:
        """Open phase ``name`` of ``part``, counting ``steps``; with
        ``sync`` the host then waits for the work queued ahead of it on
        the stream (the phase's host seconds are that wait)."""
        event = self._event()
        self._marks.append((name, part, steps, clock(), event))
        if sync and event is not None:
            event.synchronize()

    def close(self):
        """End the open phase; its closing event (None on the CPU or with
        no phase open)."""
        if not self._marks:
            return None
        event = self._event()
        self._marks.append(("", "", 0, clock(), event))
        return event

    def resolve(self) -> List[Phase]:
        """The closed phases as floats; the events are dropped."""
        marks, self._marks = self._marks, []
        out = []
        for (name, part, steps, t0, e0), (_, _, _, t1, e1) in zip(
                marks, marks[1:]):
            host = t1 - t0
            dev = host if e0 is None else e0.elapsed_time(e1) * 1e-3
            out.append(Phase(name, t0, host, dev, steps, part))
        return out


def phase_totals(phases, into: Optional[Dict[str, Dict[str, float]]] = None) \
        -> Dict[str, Dict[str, float]]:
    """Sum ``Phase``s by name: ``{name: {"device_s", "host_s", "count",
    "steps"}}``, added to ``into`` where given."""
    out = {} if into is None else into
    for p in phases:
        t = out.get(p.name)
        if t is None:
            t = out[p.name] = {"device_s": 0.0, "host_s": 0.0, "count": 0,
                               "steps": 0}
        t["device_s"] += p.device_s
        t["host_s"] += p.host_s
        t["count"] += 1
        t["steps"] += p.steps
    return out


def bucket(n: int) -> int:
    """The batch bucket of a chunk of ``n`` rows: the next power of two."""
    b = 1
    while b < n:
        b *= 2
    return b


@dataclass
class GroupDef:
    """A device group of the serving engine or of the trainer."""
    name: str
    kind: DeviceKind
    device: Optional[object] = None   # torch.device / str; None = cuda:0
    fixed_chunk: Optional[int] = None
    async_depth: int = 1
    priority_boost: bool = False
    slowdown: float = 1.0          # artificial slowdown for straggler tests
    fail_after_chunks: Optional[int] = None   # fault injection


def resolve_device(device) -> torch.device:
    """``None`` means the card (``cuda:0``); with no CUDA device that
    raises instead of falling back to the CPU. The CPU is used only when
    asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA GPU is available; pass device='cpu' to run on the "
                "CPU")
        return torch.device("cuda", 0)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    return device


def group_devices(cfg, groups: List[GroupDef],
                  verb: str) -> Dict[str, torch.device]:
    """Each group's device (``resolve_device``) by name. The CUDA kernels
    take bfloat16, so a config of another dtype with a CUDA group is
    refused, before any weight is placed; the message tells the caller to
    ``verb`` it on the CPU."""
    devices = {g.name: resolve_device(g.device) for g in groups}
    cuda = sorted(n for n, d in devices.items() if d.type == "cuda")
    if cuda and cfg.activation_dtype != torch.bfloat16:
        raise ValueError(
            f"{cfg.arch_id} in {cfg.dtype} on CUDA (groups {cuda}): the "
            f"CUDA kernels take bfloat16; {verb} {cfg.dtype} on the CPU")
    return devices


class TorchChunkExecutor(ChunkExecutor):
    """Runs a step on one torch device with measured offload phases.

    make_inputs(token) -> dict / tuple / single numpy array for the chunk
    step(device_inputs) -> outputs (device tensors; enqueued, not waited on)
    fetch(outputs) -> small host metrics (device-to-host phase)

    ``name`` labels the executor (the engine's namespaced group name).
    On CUDA every chunk runs on the executor's own ``torch.cuda.Stream``:
    inputs go from pinned host memory with ``non_blocking=True``
    (tg1→tg2), the step is enqueued (tg3 when the enqueue returns), and
    readiness is a ``torch.cuda.Event`` recorded after the step and probed
    with ``query()``. The step must not synchronise the host (no
    ``.item()`` / ``.cpu()`` on a device tensor), or ``async_depth ≥ 2``
    pipelines nothing. On the CPU the outputs are ready when the step
    returns: there is no event to probe, so poll mode degrades to block.

    With ``time_phases``, ``make_inputs``, ``step`` and ``fetch`` mark the
    phases of the chunk in hand (``mark``, ``settle``) on a
    ``PhaseMarks`` of the executor's stream; the step's last phase ends
    at the readiness event. A chunk's marks are resolved at its
    completion, after its readiness event, into ``rec.meta["phases"]``
    (a list of ``Phase``, in order).
    Without it ``mark`` and ``settle`` return at once: no clock read, no
    event.
    """

    #: bounded-backoff schedule for the readiness poll: a few free yields
    #: first (completion is usually imminent), then exponential sleeps
    #: capped so a long kernel costs at most POLL_MAX_S of detection lag
    POLL_MIN_S = 5e-5
    POLL_MAX_S = 1e-3

    def __init__(self, step: Callable, make_inputs: Callable[[Token], Any],
                 fetch: Optional[Callable[[Any], Any]] = None,
                 device=None, async_depth: int = 1,
                 priority_boost: bool = False,
                 completion_mode: str = "poll", name: str = "",
                 time_phases: bool = False):
        if completion_mode not in ("poll", "block"):
            raise ValueError(f"completion_mode must be 'poll' or 'block', "
                             f"got {completion_mode!r}")
        if device is None:
            raise ValueError("TorchChunkExecutor needs an explicit device")
        self.name = name
        self.step = step
        self.make_inputs = make_inputs
        self.fetch = fetch or (lambda outs: None)
        self.device = torch.device(device)
        self.async_depth = max(1, async_depth)
        self.priority_boost = priority_boost
        self.completion_mode = completion_mode
        self.time_phases = time_phases
        self.boosted = False
        self._stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        # (record, outputs, readiness event or None, pinned host inputs,
        # the step's phase marks or None)
        self._inflight: Deque[Tuple[ChunkRecord, Any, Any, Any, Any]] = \
            collections.deque()
        # the phase marks of the chunk in hand, and the part of it that
        # is running (None while no chunk is in hand, or untimed)
        self._marks: Optional[PhaseMarks] = None
        self._part = ""
        self._lost_chunks: List[Chunk] = []       # popped, then failed
        self._pending_done: List[ChunkRecord] = []  # done, not yet returned
        # whether dispatched chunks carry a readiness event — decided on
        # the first dispatch. CPU outputs have none, and "no probe" would
        # read as "always ready", so poll mode degrades to block there.
        self._poll_ok: Optional[bool] = None

    def on_worker_start(self) -> None:
        if self.priority_boost:
            self.boosted = try_boost_priority()

    # -- device plumbing -----------------------------------------------
    @property
    def stream(self) -> Optional[torch.cuda.Stream]:
        """The executor's CUDA stream (None on the CPU): every chunk's
        copies and step run on it."""
        return self._stream

    # -- phases --------------------------------------------------------
    def mark(self, name: str, steps: int = 0, wait: bool = False) -> None:
        """Open phase ``name`` of the chunk in hand (ending the one
        before), counting ``steps``; called from ``make_inputs``, ``step``
        or ``fetch``, outside any graph capture. With ``wait`` the phase
        is a wait: the stream waits in it for other work (its device
        seconds are the stall, part of no step)."""
        if self._marks is not None:
            self._marks.mark(name, "wait" if wait else self._part, steps)

    def settle(self, name: str) -> None:
        """Open phase ``name`` and wait there for the work queued ahead
        on the executor's stream: the host's wait is the phase's host
        seconds, and no part of the step's or the fetch's device time
        (``fetch`` calls it before its copy, which the stream would run
        after the next chunk anyway). On the CPU nothing is queued."""
        if self._marks is not None:
            self._marks.mark(name, "wait", sync=True)

    def _in_hand(self, marks: Optional[PhaseMarks], part: str) -> None:
        self._marks, self._part = marks, part

    def _stream_ctx(self):
        return torch.cuda.stream(self._stream) \
            if self._stream is not None else contextlib.nullcontext()

    def _to_device(self, host_inputs: Any) -> Tuple[Any, Any]:
        """Host numpy inputs (an array, or a dict / tuple of them) ->
        (device tensors, pinned host tensors). The pinned staging tensors
        ride along in the in-flight entry so they outlive the
        asynchronous copy."""
        if isinstance(host_inputs, dict):
            pairs = {k: self._to_device(v) for k, v in host_inputs.items()}
            return ({k: d for k, (d, _) in pairs.items()},
                    [h for _, h in pairs.values()])
        if isinstance(host_inputs, tuple):
            pairs = [self._to_device(v) for v in host_inputs]
            return tuple(d for d, _ in pairs), [h for _, h in pairs]
        t = torch.as_tensor(host_inputs)
        if self._stream is None:
            return t.to(self.device), None
        pinned = t.pin_memory()
        return pinned.to(self.device, non_blocking=True), pinned

    # -- event-driven completion ---------------------------------------
    def _polling(self) -> bool:
        return self.completion_mode == "poll" and bool(self._poll_ok)

    @staticmethod
    def _is_ready(event) -> bool:
        """Non-blocking readiness probe; no event (CPU) means ready."""
        return event is None or event.query()

    def _wait_ready(self, event) -> None:
        """Wait for the chunk's event without parking the dispatcher in a
        hard ``synchronize``: poll with a bounded-backoff yield (the
        paper's anti-oversubscription wait). ``completion_mode="block"``
        restores the synchronous wait (the paper's baseline Dynamic)."""
        if event is None:
            return
        if not self._polling():
            event.synchronize()
            return
        delay = 0.0
        while not event.query():
            time.sleep(delay)       # 0.0 first: yield, don't nap
            delay = min(max(delay * 2.0, self.POLL_MIN_S), self.POLL_MAX_S)

    def _complete_oldest(self, known_ready: bool = False) -> ChunkRecord:
        rec, outs, event, _pinned, marks = self._inflight.popleft()
        fetch_marks = None if marks is None else PhaseMarks(self._stream)
        try:
            if not known_ready:     # readiness not just probed by caller
                self._wait_ready(event)
            rec.tg4 = clock()
            self._in_hand(fetch_marks, "fetch")
            with self._stream_ctx():
                res = self.fetch(outs)
            rec.tg5 = clock()
        except BaseException:
            # the popped chunk is in neither _inflight nor the caller's
            # hands — remember it so abort() can hand it back for requeue
            self._lost_chunks.append(rec.token.chunk)
            raise
        finally:
            self._in_hand(None, "")
        if marks is not None:
            # the step's events have passed (readiness); the fetch's close
            # right after its copy, which the host has waited for
            end = fetch_marks.close()
            if end is not None:
                end.synchronize()
            rec.meta["phases"] = marks.resolve() + fetch_marks.resolve()
        # Tc3 (host resumed after completion) is stamped here, per record:
        # with async_depth ≥ 2 several records drain in one call, and a
        # single batch-level stamp would inflate O_td for all but the last
        rec.tc3 = clock()
        if res is not None:
            rec.meta["result"] = res
        return rec

    def execute(self, token: Token, rec: ChunkRecord) -> List[ChunkRecord]:
        done: List[ChunkRecord] = self._pending_done
        self._pending_done = []
        try:
            # opportunistic drain: anything already finished completes now
            # (no wait), so completion latency is hidden behind dispatch
            # instead of accumulating until the pipeline fills
            if self._polling():
                while self._inflight \
                        and self._is_ready(self._inflight[0][2]):
                    done.append(self._complete_oldest(known_ready=True))
            while len(self._inflight) >= self.async_depth:
                done.append(self._complete_oldest())
            marks = PhaseMarks(self._stream) if self.time_phases else None
            self._in_hand(marks, "inputs")
            try:
                host_inputs = self.make_inputs(token)
                with self._stream_ctx():
                    rec.tg1 = clock()
                    dev_inputs, pinned = self._to_device(host_inputs)
                    rec.tg2 = clock()
                    self._part = "step"
                    outs = self.step(*dev_inputs) \
                        if isinstance(dev_inputs, tuple) \
                        else self.step(dev_inputs)
                    rec.tg3 = clock()           # enqueue returned (async)
            finally:
                self._in_hand(None, "")
            # readiness: the step's closing mark where it has phases
            event = marks.close() if marks is not None else None
            if event is None and self._stream is not None:
                event = torch.cuda.Event()
                event.record(self._stream)
            if self._poll_ok is None:
                self._poll_ok = event is not None
            self._inflight.append((rec, outs, event, pinned, marks))
            if self.async_depth == 1:
                done.append(self._complete_oldest())
        except BaseException:
            # a failure anywhere (completion OR launch of the new chunk)
            # must not discard records that already finished in this call
            self._pending_done = done
            raise
        return done

    def drain(self) -> List[ChunkRecord]:
        out = self._pending_done
        self._pending_done = []
        try:
            while self._inflight:
                out.append(self._complete_oldest())
        except BaseException:
            self._pending_done = out      # keep finished records visible
            raise
        return out

    def cancel(self) -> List[ChunkRecord]:
        """Cancellation wind-down: complete only the chunks whose outputs
        are already ready (free — no wait), leaving genuinely in-flight
        device work queued for ``abort()``/requeue. Without a readiness
        probe (block mode / CPU) there is no way to tell done from
        running, so fall back to a full drain — the submitted work is
        finishing either way; draining just keeps its records instead of
        discarding real results."""
        out = self._pending_done
        self._pending_done = []
        try:
            if not self._polling():
                while self._inflight:
                    out.append(self._complete_oldest())
            else:
                while self._inflight \
                        and self._is_ready(self._inflight[0][2]):
                    out.append(self._complete_oldest(known_ready=True))
        except BaseException:
            self._pending_done = out      # keep finished records visible
            raise
        return out

    def abort(self) -> List[Chunk]:
        """Drop the in-flight chunks unfetched and return them for
        requeue; their kernels may still be queued on the stream. Dropping
        their tensors there is safe: every one was allocated on this
        executor's stream, and the caching allocator hands a freed block
        only to later work on the same stream, which runs after the
        dropped kernels; a pinned staging buffer is reused only once the
        event its copy recorded has passed."""
        chunks = self._lost_chunks
        chunks += [rec.token.chunk for rec, *_ in self._inflight]
        self._lost_chunks = []
        self._inflight.clear()
        return chunks

    def completed(self) -> List[ChunkRecord]:
        done, self._pending_done = self._pending_done, []
        return done


class SleepExecutor(ChunkExecutor):
    """Deterministic executor for scheduler unit tests: service time is
    chunk.size / rate plus fixed per-phase overheads. ``fail_after`` kills
    the group after N chunks; ``slow_after`` divides the rate by
    ``slow_factor`` after N chunks (a mid-run straggler)."""

    def __init__(self, rate: float, t_hd: float = 0.0, t_kl: float = 0.0,
                 t_dh: float = 0.0, fail_after: Optional[int] = None,
                 slow_after: Optional[int] = None, slow_factor: float = 10.0,
                 clock: Optional[Callable[[], float]] = None,
                 sleep: Optional[Callable[[float], None]] = None):
        self.rate = rate
        self.t_hd, self.t_kl, self.t_dh = t_hd, t_kl, t_dh
        self.fail_after = fail_after
        self.slow_after = slow_after
        self.slow_factor = slow_factor
        # injectable time source/sink: the deterministic test harness
        # (tests/clock.py VirtualClock) substitutes both so simulated
        # service time advances a virtual timeline instead of the wall
        self.clock = clock if clock is not None else globals()["clock"]
        self.sleep = sleep if sleep is not None else time.sleep
        self._count = 0

    def execute(self, token: Token, rec: ChunkRecord) -> List[ChunkRecord]:
        self._count += 1
        if self.fail_after is not None and self._count > self.fail_after:
            raise ChunkFailure(f"group {token.group} died")
        rate = self.rate
        if self.slow_after is not None and self._count > self.slow_after:
            rate = self.rate / self.slow_factor
        # skip zero-duration sleeps: time.sleep(0.0) is still a syscall
        # (~µs each, up to four per chunk), real overhead a *simulated*
        # run must not pay on its host-path measurements
        service = token.chunk.size / rate
        rec.tg1 = self.clock()
        if self.t_hd:
            self.sleep(self.t_hd)
        rec.tg2 = self.clock()
        if self.t_kl:
            self.sleep(self.t_kl)
        rec.tg3 = self.clock()
        if service:
            self.sleep(service)
        rec.tg4 = self.clock()
        if self.t_dh:
            self.sleep(self.t_dh)
        rec.tg5 = self.clock()
        return [rec]
