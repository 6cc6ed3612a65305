"""A chunk's step as a CUDA graph: the capture and the replay that the
serving engine's graphs (``serve.graphs``) and the trainer's
(``train.graphs``) share.

- ``record`` captures one step on an executor's stream. It first runs the
  step (or another warm-up) eagerly on that stream: this builds the
  kernels, sets their attributes and allocates what a graph reads at a
  fixed address (K2's split tickets, the RoPE tables, cuBLAS's workspace)
  outside the graph's memory pool. It then synchronises the stream and
  returns the blocks the warm-up left cached to the stream's device,
  since the graph's private pool could not reuse them, and captures the
  step, into a pool of its own or into another graph's.
- Captures run in ``thread_local`` mode and take turns on a device
  (``capturing``): other dispatcher threads may query events, synchronise
  their streams and allocate meanwhile.
- ``replay`` copies a call's inputs into the graph's static buffers and
  replays it on its stream.
- A capture's launches, its warm-up's included, are not counted; each
  replay counts those its capture recorded (``kernels.launch_count``).

Nothing falls back to eager: a capture or a replay that raises is counted
in ``GraphCounts.failures`` and raised. A capture lost to an error in the
step (an out-of-memory error, say) raises that error, not the one that
ending the lost capture raises.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.launch_count import CountedGraph, uncounted

_capture_locks: Dict[torch.device, threading.Lock] = {}
_capture_locks_guard = threading.Lock()


def capture_lock(device: torch.device) -> threading.Lock:
    """The lock that captures on ``device`` take in turn."""
    with _capture_locks_guard:
        return _capture_locks.setdefault(torch.device(device),
                                         threading.Lock())


def same_leaves(a, b) -> bool:
    """Whether two weight trees hold the same tensors."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same_leaves(a[k], b[k]) for k in a)
    return a is b


def replay(graph: CountedGraph, stream: torch.cuda.Stream, inputs,
           counts: "GraphCounts", pair: Tuple[str, int], read=None):
    """Copy ``inputs`` ((static buffer, tensor) pairs) and replay ``graph``
    on ``stream``; then, still on ``stream``, ``read()`` what must be taken
    from the static outputs before the next replay overwrites them, and
    return it. A caller on another stream (the tests, chip_smoke.py) is
    ordered around it both ways; an executor's own step, on that stream,
    needs no ordering."""
    caller = torch.cuda.current_stream(stream.device)
    other = caller != stream
    if other:
        stream.wait_stream(caller)
    with torch.cuda.stream(stream):
        for buf, t in inputs:
            buf.copy_(t)
        try:
            graph.replay()
        except BaseException:
            counts.failed()
            raise
        out = read() if read is not None else None
    counts.replayed(pair)
    if other:
        caller.wait_stream(stream)
    return out


class GraphCounts:
    """An engine's or a trainer's graph counters, shared by its dispatcher
    threads: captures (one per executor and bucket), replays (of any of
    its graphs, per (executor, bucket) too), failures (a capture or replay
    that raised), graphs dropped to make room for another bucket's (the
    trainer's), and the seconds of each capture (``capture_end``
    instantiates the graph, so a capture's seconds include its
    instantiation)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.captures = 0
        self.replays = 0
        self.failures = 0
        self.drops = 0
        self.replays_by_pair: Dict[Tuple[str, int], int] = {}
        self.capture_log: List[Dict] = []

    def captured(self, entry: Dict) -> None:
        with self._lock:
            self.captures += 1
            self.capture_log.append(entry)

    def replayed(self, pair: Tuple[str, int]) -> None:
        with self._lock:
            self.replays += 1
            self.replays_by_pair[pair] = self.replays_by_pair.get(pair, 0) + 1

    def failed(self) -> None:
        with self._lock:
            self.failures += 1

    def dropped(self, n: int) -> None:
        with self._lock:
            self.drops += n

    def snapshot(self) -> Dict:
        with self._lock:
            return {"captures": self.captures, "replays": self.replays,
                    "failures": self.failures, "drops": self.drops,
                    "replays_by_pair": dict(self.replays_by_pair),
                    "capture_log": [dict(e) for e in self.capture_log]}


@contextlib.contextmanager
def capturing(device: torch.device, counts: GraphCounts):
    """Hold ``device``'s turn to capture (``capture_lock``); whatever
    raises inside is counted in ``counts.failures`` and raised."""
    try:
        with capture_lock(device):
            yield
    except BaseException:
        counts.failed()
        raise


class Recorded(NamedTuple):
    graph: CountedGraph
    #: what the captured ``fn`` returned, left in the graph's pool: the
    #: next replay overwrites it
    out: object
    #: the bytes the capture added to the device's reserved memory
    pool_bytes: int
    warmup_s: float
    capture_s: float


def record(fn: Callable, stream: torch.cuda.Stream, n: int = 0,
           warm: Optional[Callable] = None, pool=None) -> Recorded:
    """Capture ``fn()`` on ``stream``, inside ``capturing``. First ``warm``
    (``fn`` by default) runs ``n`` times eagerly on the stream, the stream
    is synchronised and the blocks the warm-up left cached go back to its
    device; with ``n = 0`` the capture starts at once (a graph that
    shares the ``pool`` of one captured just before)."""
    t0 = time.perf_counter()
    if n:
        with torch.cuda.stream(stream), uncounted(stream):
            for _ in range(n):
                (warm or fn)()
        stream.synchronize()
        with torch.cuda.device(stream.device):
            torch.cuda.empty_cache()
    t1 = time.perf_counter()
    before = torch.cuda.memory_reserved(stream.device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream), uncounted(stream) as tally:
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            out = fn()
        except BaseException:
            # the capture is lost: end it, and raise the error that lost
            # it, not the end's
            with contextlib.suppress(RuntimeError):
                graph.capture_end()
            raise
        graph.capture_end()
    return Recorded(CountedGraph(graph, tally), out,
                    torch.cuda.memory_reserved(stream.device) - before,
                    t1 - t0, time.perf_counter() - t1)
