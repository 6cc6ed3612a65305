"""Elastic scaling: device groups join/leave the live scheduler runtime.

Join: DynamicScheduler.add_group spawns a dispatcher thread that enters the
oldest open epoch; the partitioner seeds the newcomer's λ and eq. (4)
immediately sizes its chunks — no global pause, no re-partitioning of
in-flight work. Leave: DynamicScheduler.remove_group drains the group out
*everywhere* (specs, executors, partitioner) so neither a scheduler rebuild
nor the persistent runtime's next epoch can resurrect it; ChunkFailure
(abrupt, chunk requeued) takes the same path in-band. This module is the
small policy layer: it owns GroupSpec construction and the λ seeding choice
for newcomers (median of current same-kind groups, so a new BIG node
doesn't start with a wildly wrong chunk size).

When an AdmissionController (repro_torch.queue) is attached, join/leave events
flow to it so advertised capacity — and therefore the queue-delay
backpressure gate — tracks topology changes immediately.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.core.dispatch import ChunkExecutor
from repro_torch.core.scheduler import DynamicScheduler
from repro_torch.core.types import DeviceKind, GroupSpec


class ElasticController:
    def __init__(self, scheduler: DynamicScheduler, admission=None):
        self.scheduler = scheduler
        self.admission = admission      # Optional[AdmissionController]

    def _seed_lambda(self, kind: DeviceKind) -> Optional[float]:
        peers = [g for g in self.scheduler.specs.values() if g.kind == kind]
        lams = sorted(self.scheduler.tracker.get(g.name) for g in peers)
        if not lams:
            return None
        return lams[len(lams) // 2]

    def join(self, name: str, kind: DeviceKind, executor: ChunkExecutor,
             fixed_chunk: Optional[int] = None,
             min_chunk: int = 1) -> GroupSpec:
        lam = self._seed_lambda(kind) or 1.0
        spec = GroupSpec(name, kind, fixed_chunk=fixed_chunk,
                         min_chunk=min_chunk, init_throughput=lam)
        self.scheduler.add_group(spec, executor)
        if self.admission is not None:
            self.admission.on_group_join(name, lam)
        return spec

    def leave(self, name: str):
        # remove everywhere — leaving the group in scheduler.specs /
        # scheduler.executors would resurrect it on the next epoch (or on
        # any rebuild from those dicts)
        self.scheduler.remove_group(name)
        if self.admission is not None:
            self.admission.on_group_leave(name)
