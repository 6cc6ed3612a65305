"""Multi-tenant scheduling: sharded queues, weighted-fair drain, quotas,
per-tenant energy/EDP accounting.

The queue subsystem (`repro_torch.queue`) arbitrates *jobs*; this package
arbitrates *tenants* on top of it: a TenantRegistry holds each tenant's
contract (DWRR weight, in-flight quota, queue-delay SLO, soft energy
budget), a ShardedQueueManager drains one QueueManager shard per tenant
in deficit-weighted-round-robin order, and a TenantAccountant attributes
each drained batch's busy time and joules back to tenants — closing the
loop by derating the weight of tenants past their energy budget. With a
single (default) tenant every piece degenerates to the unsharded
single-queue behavior.
"""
from repro_torch.tenancy.spec import (DEFAULT_TENANT, TenantRegistry, TenantSpec)
from repro_torch.tenancy.sharded_queue import ShardedQueueManager
from repro_torch.tenancy.accounting import TenantAccountant, TenantUsage

__all__ = [
    "DEFAULT_TENANT", "TenantRegistry", "TenantSpec",
    "ShardedQueueManager", "TenantAccountant", "TenantUsage",
]
