"""Bulk-Oracle baseline (paper §2) for real execution.

Static split: the accelerator group gets one bulk chunk of ``frac·N`` at the
start; the other groups dynamically share the rest. The *oracle* variant
sweeps ``frac`` offline (0..100% in 10% steps, as the paper does) and keeps
the best run.

Copied from ``repro.core.oracle`` with two repairs: ``run`` refuses a split
that leaves iterations to non-accel groups when there are none (the
reference drops them and reports success), and ``oracle`` steps the split
as ``k / round(1/step)``, so that its last run is exactly 100% (the
reference's accumulated ``f += step`` ends at 0.9999999999999999).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from repro_torch.core.dispatch import ChunkExecutor, clock
from repro_torch.core.overheads import OverheadLedger
from repro_torch.core.throughput import ThroughputTracker
from repro_torch.core.types import Chunk, ChunkRecord, DeviceKind, GroupSpec, \
    IterationSpace, Token


@dataclass
class BulkResult:
    total_time: float
    frac: float
    records: List[ChunkRecord]
    per_group_items: Dict[str, int]


class BulkScheduler:
    """One static-split run."""

    def __init__(self, groups: Dict[str, GroupSpec],
                 executors: Dict[str, ChunkExecutor],
                 cpu_quantum: Optional[int] = None):
        self.specs = dict(groups)
        self.executors = dict(executors)
        self.cpu_quantum = cpu_quantum
        accels = [g for g in self.specs.values()
                  if g.kind == DeviceKind.ACCEL]
        assert len(accels) == 1, "BulkScheduler expects exactly one accel"
        self.accel = accels[0]

    def run(self, begin: int, end: int, frac: float) -> BulkResult:
        n = end - begin
        n_accel = int(n * frac)
        if n_accel < n and len(self.specs) == 1:
            raise ValueError(
                f"frac {frac} leaves {n - n_accel} of {n} iterations to "
                f"non-accel groups, and there are none")
        records: List[ChunkRecord] = []
        lock = threading.Lock()
        space = IterationSpace(begin + n_accel, end)
        quantum = self.cpu_quantum or max(
            1, (n - n_accel) // max(1, 8 * (len(self.specs) - 1) or 1))

        def run_one(name: str, token: Token):
            ex = self.executors[name]
            rec = ChunkRecord(token, tc1=clock(), tc2=clock())
            done = ex.execute(token, rec)
            done += ex.drain()
            t = clock()
            for r in done:
                r.tc3 = t
            with lock:
                records.extend(done)

        def accel_worker():
            if n_accel:
                tok = Token(Chunk(begin, begin + n_accel, 0),
                            self.accel.name, DeviceKind.ACCEL)
                run_one(self.accel.name, tok)

        def cpu_worker(name: str):
            ex = self.executors[name]
            while True:
                c = space.take(quantum)
                if c is None:
                    break
                tok = Token(c, name, self.specs[name].kind)
                rec = ChunkRecord(tok, tc1=clock(), tc2=clock())
                done = ex.execute(tok, rec)
                t = clock()
                for r in done:
                    r.tc3 = t
                with lock:
                    records.extend(done)
            with lock:
                records.extend(ex.drain())

        t0 = clock()
        threads = [threading.Thread(target=accel_worker, daemon=True)]
        for name, g in self.specs.items():
            if g.kind != DeviceKind.ACCEL:
                threads.append(threading.Thread(
                    target=cpu_worker, args=(name,), daemon=True))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        total = clock() - t0
        items: Dict[str, int] = {}
        for r in records:
            items[r.token.group] = items.get(r.token.group, 0) \
                + r.token.chunk.size
        return BulkResult(total, frac, records, items)

    def oracle(self, begin: int, end: int, step: float = 0.1) -> BulkResult:
        best = None
        n_steps = round(1 / step)
        for k in range(n_steps + 1):
            r = self.run(begin, end, k / n_steps)
            if best is None or r.total_time < best.total_time:
                best = r
        return best
