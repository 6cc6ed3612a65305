"""repro_torch.chaos — seedable, deterministic fault injection at every layer.

``FaultPlan.generate(seed, ...)`` builds a byte-stable schedule of
layered faults; a shared ``ChaosInjector`` answers active/due queries
for the hooks (``ChaosExecutor``, ``ChaosSink``, the journal write
filter, skewed clocks, listener drops) and counts every injection under
``chaos.injected{layer,kind}``. benchmarks/chaos_soak.py drives N seeded
plans against a federated serve and hard-fails on job loss, duplicate
completion, or slow recovery; ``--chaos-seed`` / ``--chaos-plan`` wire
the same plane into the serve CLI.
"""
from repro_torch.chaos.plan import KINDS, LAYERS, FaultEvent, FaultPlan
from repro_torch.chaos.injector import ChaosExecutor, ChaosInjector, ChaosSink

__all__ = ["FaultEvent", "FaultPlan", "ChaosExecutor", "ChaosInjector",
           "ChaosSink", "KINDS", "LAYERS"]
