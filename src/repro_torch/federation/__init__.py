"""Multi-runtime federation: one service, many scheduler runtimes.

See ``repro_torch.federation.service`` for the architecture overview.
"""
from repro_torch.federation.gossip import GossipBus, Heartbeat
from repro_torch.federation.replication import ReplicaSink, ReplicationRing
from repro_torch.federation.router import Router
from repro_torch.federation.service import (FederatedService, FederationReport,
                                      RuntimeNode)

__all__ = [
    "FederatedService", "FederationReport", "GossipBus", "Heartbeat",
    "ReplicaSink", "ReplicationRing", "Router", "RuntimeNode",
]
