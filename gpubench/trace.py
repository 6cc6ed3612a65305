"""The device trace of a traced window, from ``torch.profiler``, reduced to
what the per-layer metrics read: the seconds in which any kernel or copy
ran (the union of their intervals), the window's length, each
hand-written kernel's launches and device seconds, the operations that
took most device time, and the longest idle gaps by what the host was
doing meanwhile.
"""
from __future__ import annotations

import bisect
import sys
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

from gpubench import cost


def union_s(intervals: List[Tuple[float, float]]) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(intervals: List[Tuple[float, float]], t0: float, t1: float) \
        -> List[Tuple[float, float]]:
    """The stretches of [t0, t1] that no interval covers."""
    out, at = [], t0
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, t1)))
        at = max(at, e)
    if at < t1:
        out.append((at, t1))
    return [(s, e) for s, e in out if e > s]


#: idle gaps shorter than this are summed under one name, not attributed
#: to a host event: the launch latency between a graph's kernels
SHORT_GAP_S = 50e-6
SHORT = "(gaps under 50 us)"


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    #: kernel key ("k1", ...) -> device seconds of each launch
    kernels: Dict[str, List[float]] = field(default_factory=dict)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def _events(prof):
    """(is_device, name, start_s, end_s) of every event the profiler
    kept, read from its raw results (parsing them into ``FunctionEvent``s
    takes far longer at a million kernels). A range the host annotated
    (``record_function``) also appears on the device's timeline, spanning
    the kernels launched inside it: it is no device work, and is left
    out."""
    cuda = torch.autograd.DeviceType.CUDA
    raw = getattr(prof.profiler, "kineto_results", None)
    if raw is None:
        return [(e.device_type == cuda, e.name, e.time_range.start * 1e-6,
                 e.time_range.end * 1e-6) for e in prof.events()
                if not (e.device_type == cuda
                        and getattr(e, "is_user_annotation", False))]
    out = []
    for e in raw.events():
        dev = e.device_type() == cuda
        if dev and e.is_user_annotation():
            continue
        start = e.start_ns() * 1e-9
        out.append((dev, e.name(), start, start + e.duration_ns() * 1e-9))
    return out


def reduce(events, t0: float, t1: float) -> TraceSummary:
    """Summarise ``events`` over the window [t0, t1] (seconds on the
    profiler's clock)."""
    dev = [(s, e, n) for d, n, s, e in events if d and e > t0 and s < t1]
    spans = [(max(s, t0), min(e, t1)) for s, e, _ in dev]
    busy = union_s(spans)
    kernels: Dict[str, List[float]] = defaultdict(list)
    by_name: Dict[str, float] = defaultdict(float)
    for s, e, n in dev:
        by_name[n] += e - s
        k = cost.kernel_of(n)
        if k is not None:
            kernels[k].append(e - s)
    host = sorted((s, e, n) for d, n, s, e in events if not d)
    starts = [s for s, _, _ in host]
    idle: Dict[str, float] = defaultdict(float)
    for gs, ge in gaps(spans, t0, t1):
        if ge - gs < SHORT_GAP_S:
            idle[SHORT] += ge - gs
            continue
        mid = 0.5 * (gs + ge)
        # the shortest host event open at the gap's middle: what the host
        # was doing while the device waited
        best, name = float("inf"), "(no host event)"
        i = bisect.bisect_right(starts, mid)
        for s, e, n in host[max(0, i - 2000):i]:
            if s <= mid <= e and e - s < best:
                best, name = e - s, n
        idle[name] += ge - gs
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    longest = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return TraceSummary(t1 - t0, busy, dict(kernels), top, longest)


def traced(fn: Callable[[], object], device: torch.device):
    """Run ``fn`` under the profiler. Returns (fn's result, the
    TraceSummary of the window from fn's start to its end)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("gpubench.window"):
            out = fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        t_stop = time.perf_counter()
    t_read = time.perf_counter()
    print(f"gpubench: profiler stopped in {t_read - t_stop:.1f} s",
          file=sys.stderr, flush=True)
    events = _events(prof)
    marks = [(s, e) for d, n, s, e in events
             if not d and n == "gpubench.window"]
    t0, t1 = marks[0]
    summary = reduce(events, t0, t1)
    print(f"gpubench: trace of {len(events)} events read in "
          f"{time.perf_counter() - t_read:.1f} s", file=sys.stderr,
          flush=True)
    return out, summary
