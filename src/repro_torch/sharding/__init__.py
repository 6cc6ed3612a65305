from repro_torch.sharding.rules import ShardingRules, DEFAULT_RULES, \
    LONG_CONTEXT_OVERRIDES, tree_shardings
from repro_torch.sharding.partition import lshard, use_mesh_rules, \
    active_mesh, active_rules

__all__ = ["ShardingRules", "DEFAULT_RULES", "LONG_CONTEXT_OVERRIDES",
           "tree_shardings", "lshard", "use_mesh_rules", "active_mesh",
           "active_rules"]
