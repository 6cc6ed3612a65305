"""Chunk-lifecycle span tracing: Tc1→Tc3 / Tg1→Tg5 as structured spans.

Every completed chunk becomes one host-side span (Filter₁ entry → host
resumed) with nested phase spans reconstructed from its ChunkRecord
timestamps — schedule (Tc1→Tc2), h2d (Tg1→Tg2), launch (Tg2→Tg3), kernel
(Tg3→Tg4), d2h (Tg4→Tg5) — tagged with group / epoch / chunk seq / item
count, plus the tenant composition of the batch the epoch drained
(JobService registers it via ``tag_epoch`` at submit time, before any of
the epoch's chunks complete). Queue/scheduler *events* — admission
decisions, DWRR picks, steals, refills, requeues, epoch submit/finalize —
are instant events on the same timeline.

Emission is designed for the dispatch hot path: a sampled chunk appends
ONE compact tuple to a ``collections.deque(maxlen=...)`` (GIL-atomic,
lock-free, bounded — old events fall off the front on overflow, counted);
all formatting (Chrome trace-event dicts, sorting, tid mapping) happens
at export time on the reader's thread. ``sample_rate`` (default 1.0)
deterministically keeps a chunk by hashing its seq, so two runs over the
same schedule sample the same chunks.

Export is Chrome trace-event JSON — ``chrome_trace()`` returns the
``{"traceEvents": [...]}`` object that chrome://tracing and Perfetto load
directly. Host spans for one group live on one track (tid), device-phase
spans on a sibling ``<group>/dev`` track, so pipelined executors
(async_depth ≥ 2) cannot break host-span stack nesting.
"""
from __future__ import annotations

import collections
import json
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

clock = time.monotonic

#: Knuth multiplicative hash → uniform [0, 1) per chunk seq, so sampling
#: is deterministic for a given schedule and rate.
_HASH_MUL = 0x9E3779B1
_HASH_DEN = float(2 ** 32)

_CHUNK = 0        # chunk lifecycle (from a ChunkRecord)
_SPAN = 1         # generic duration span (service batches, exports)
_INSTANT = 2      # point event (steal, requeue, admission, epoch marks)


class SpanTracer:
    def __init__(self, sample_rate: float = 1.0,
                 max_events: int = 200_000,
                 max_epoch_tags: int = 4096):
        self.sample_rate = float(sample_rate)
        self.max_events = int(max_events)
        self._events: collections.deque = collections.deque(
            maxlen=self.max_events)
        self.emitted = 0                    # sampled-in events ever emitted
        self.sampled_out = 0                # chunks skipped by sampling
        self._epoch_tags: Dict[int, Dict[str, Any]] = {}
        self._max_epoch_tags = max_epoch_tags
        self._tag_lock = threading.Lock()

    # -- sampling -------------------------------------------------------
    def sampled(self, seq: int) -> bool:
        if self.sample_rate >= 1.0:
            return True
        if self.sample_rate <= 0.0:
            return False
        return ((seq * _HASH_MUL) & 0xFFFFFFFF) / _HASH_DEN \
            < self.sample_rate

    # -- epoch tagging (service layer knows tenants; scheduler doesn't) -
    def tag_epoch(self, index: int, tags: Dict[str, Any]) -> None:
        """Attach batch metadata (tenant item shares, job count) to an
        epoch index before its chunks complete; chunk spans pick it up at
        export. Bounded: oldest tags are dropped past ``max_epoch_tags``."""
        with self._tag_lock:
            self._epoch_tags[index] = tags
            while len(self._epoch_tags) > self._max_epoch_tags:
                self._epoch_tags.pop(next(iter(self._epoch_tags)))

    def epoch_tag(self, index: Optional[int]) -> Dict[str, Any]:
        with self._tag_lock:
            return dict(self._epoch_tags.get(index, ()))

    # -- emission (hot path: one tuple append) --------------------------
    def chunk(self, rec, epoch: Optional[int] = None) -> None:
        """Record one completed chunk's lifecycle (duck-typed
        ChunkRecord). Sampled by chunk seq; one deque append."""
        seq = rec.token.chunk.seq
        if not self.sampled(seq):
            self.sampled_out += 1
            return
        self.emitted += 1
        self._events.append((
            _CHUNK, rec.token.group, epoch, seq, rec.token.chunk.size,
            rec.tc1, rec.tc2, rec.tc3,
            rec.tg1, rec.tg2, rec.tg3, rec.tg4, rec.tg5))

    def span(self, name: str, tid: str, start: float, end: float,
             **args) -> None:
        self.emitted += 1
        self._events.append((_SPAN, name, tid, start, end, args or None))

    def instant(self, name: str, tid: str = "events",
                ts: Optional[float] = None, **args) -> None:
        self.emitted += 1
        self._events.append((_INSTANT, name, tid,
                             ts if ts is not None else clock(),
                             args or None))

    def __len__(self) -> int:
        return len(self._events)

    @property
    def dropped(self) -> int:
        """Events evicted from the bounded ring (emitted but no longer
        retained)."""
        return max(0, self.emitted - len(self._events))

    # -- export ---------------------------------------------------------
    def _chunk_events(self, ev: tuple, tids, out: List[dict]) -> None:
        (_, group, epoch, seq, size,
         tc1, tc2, tc3, tg1, tg2, tg3, tg4, tg5) = ev
        args: Dict[str, Any] = {"group": group, "seq": seq, "items": size}
        if epoch is not None:
            args["epoch"] = epoch
        tag = self.epoch_tag(epoch)
        if tag:
            args.update(tag)
        host_tid = tids(group)
        us = 1e6
        out.append({"name": f"chunk:{seq}", "cat": "chunk", "ph": "X",
                    "ts": tc1 * us, "dur": max(tc3 - tc1, 0.0) * us,
                    "pid": 0, "tid": host_tid, "args": args})
        out.append({"name": "schedule", "cat": "host", "ph": "X",
                    "ts": tc1 * us, "dur": max(tc2 - tc1, 0.0) * us,
                    "pid": 0, "tid": host_tid,
                    "args": {"seq": seq}})
        if tg5 > 0.0:                       # executor filled device stamps
            dev_tid = tids(f"{group}/dev")
            for name, a, b in (("h2d", tg1, tg2), ("launch", tg2, tg3),
                               ("kernel", tg3, tg4), ("d2h", tg4, tg5)):
                out.append({"name": name, "cat": "device", "ph": "X",
                            "ts": a * us, "dur": max(b - a, 0.0) * us,
                            "pid": 0, "tid": dev_tid,
                            "args": {"seq": seq}})

    def chrome_events(self) -> List[dict]:
        """Format the retained events as Chrome trace events (metadata
        thread-name rows first, then spans sorted by timestamp)."""
        snap = list(self._events)           # deque snapshot, GIL-atomic
        tid_of: Dict[str, int] = {}

        def tids(name: str) -> int:
            t = tid_of.get(name)
            if t is None:
                t = tid_of[name] = len(tid_of) + 1
            return t

        spans: List[dict] = []
        for ev in snap:
            if ev[0] == _CHUNK:
                self._chunk_events(ev, tids, spans)
            elif ev[0] == _SPAN:
                _, name, tid, start, end, args = ev
                spans.append({"name": name, "cat": "service", "ph": "X",
                              "ts": start * 1e6,
                              "dur": max(end - start, 0.0) * 1e6,
                              "pid": 0, "tid": tids(tid),
                              "args": args or {}})
            else:
                _, name, tid, ts, args = ev
                spans.append({"name": name, "cat": "event", "ph": "i",
                              "ts": ts * 1e6, "pid": 0, "tid": tids(tid),
                              "s": "t", "args": args or {}})
        spans.sort(key=lambda e: e["ts"])
        meta = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": t,
                 "args": {"name": name}}
                for name, t in sorted(tid_of.items(), key=lambda kv: kv[1])]
        meta.insert(0, {"name": "process_name", "ph": "M", "pid": 0,
                        "args": {"name": "repro serving runtime"}})
        return meta + spans

    def chrome_trace(self) -> Dict[str, Any]:
        return {"traceEvents": self.chrome_events(),
                "displayTimeUnit": "ms",
                "otherData": {"emitted": self.emitted,
                              "dropped": self.dropped,
                              "sample_rate": self.sample_rate}}

    def write_chrome_trace(self, path: str) -> int:
        """Write the trace JSON; returns the number of trace events."""
        trace = self.chrome_trace()
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(trace, fh)
            fh.write("\n")
        return len(trace["traceEvents"])


class LabeledTracer:
    """View over a base tracer namespacing one runtime's trace state.

    Track ids gain a ``<prefix>/`` path (each runtime's service /
    admission rows become separate Chrome-trace tracks) and epoch-tag
    keys are scoped to the prefix: N federated runtimes each count their
    epochs from 0, so raw integer keys would collide in the shared tag
    map and stamp one runtime's tenant composition onto another's chunk
    spans. Chunk tids need no prefix — federated group names are already
    namespaced (``r0/accel``) and flow through the ChunkRecord. Reader
    surface (``chrome_trace``, ``emitted``, ...) delegates to the base:
    one export covers every runtime."""

    def __init__(self, base: SpanTracer, prefix: str):
        self.base = base
        self.prefix = str(prefix)

    def _epoch_key(self, index) -> Optional[str]:
        return None if index is None else f"{self.prefix}:{index}"

    def chunk(self, rec, epoch=None) -> None:
        self.base.chunk(rec, epoch=self._epoch_key(epoch))

    def tag_epoch(self, index, tags: Dict[str, Any]) -> None:
        self.base.tag_epoch(self._epoch_key(index), tags)

    def epoch_tag(self, index) -> Dict[str, Any]:
        return self.base.epoch_tag(self._epoch_key(index))

    def span(self, name: str, tid: str, start: float, end: float,
             **args) -> None:
        self.base.span(name, f"{self.prefix}/{tid}", start, end, **args)

    def instant(self, name: str, tid: str = "events",
                ts: Optional[float] = None, **args) -> None:
        self.base.instant(name, f"{self.prefix}/{tid}", ts=ts, **args)

    def __getattr__(self, name):
        return getattr(self.base, name)
