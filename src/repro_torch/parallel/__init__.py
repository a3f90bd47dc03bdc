from repro_torch.parallel.sharding import (
    ACT_RULES,
    PARAM_RULES,
    SERVE_PARAM_RULES,
    ShardingRules,
    constrain,
    current_mesh,
    param_sharding_tree,
    physical_spec,
    placements,
    set_rules,
    use_mesh,
)

__all__ = [
    "ACT_RULES",
    "PARAM_RULES",
    "SERVE_PARAM_RULES",
    "ShardingRules",
    "constrain",
    "current_mesh",
    "param_sharding_tree",
    "physical_spec",
    "placements",
    "set_rules",
    "use_mesh",
]
