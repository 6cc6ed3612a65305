"""Core library: the paper's dynamic heterogeneous chunk scheduler.

Paper: "Reducing overheads of dynamic scheduling on heterogeneous chips"
(Corbera et al., 2015). The host-side stack (types, throughput tracking,
partitioner, scheduler, overhead ledger, energy model) is the JAX
package's, copied with its imports rewritten; the executor that drives a
device is torch's.
"""
from repro_torch.core.types import (Chunk, ChunkRecord, DeviceKind,
                                    GroupSpec, IterationSpace, Token)
from repro_torch.core.locks import TimedLock
from repro_torch.core.throughput import (GroupStats,
                                         LockedThroughputTracker,
                                         ThroughputTracker)
from repro_torch.core.partitioner import HeterogeneousPartitioner
from repro_torch.core.overheads import OverheadLedger, OverheadTotals
from repro_torch.core.dispatch import (CallableExecutor, ChunkExecutor,
                                       ChunkFailure, SleepExecutor,
                                       TorchChunkExecutor,
                                       try_boost_priority)
from repro_torch.core.scheduler import (DynamicScheduler, EpochHandle,
                                        ScheduleResult)
from repro_torch.core.energy import EnergyModel, EnergyReport, PowerSpec

__all__ = [
    "Chunk", "ChunkRecord", "DeviceKind", "GroupSpec", "IterationSpace",
    "Token", "ThroughputTracker", "LockedThroughputTracker", "TimedLock",
    "GroupStats", "HeterogeneousPartitioner", "OverheadLedger",
    "OverheadTotals", "CallableExecutor", "ChunkExecutor", "ChunkFailure",
    "TorchChunkExecutor", "SleepExecutor", "try_boost_priority",
    "DynamicScheduler", "EpochHandle", "ScheduleResult", "EnergyModel",
    "EnergyReport", "PowerSpec",
]
