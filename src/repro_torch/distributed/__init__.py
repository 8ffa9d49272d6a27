"""Sharding on ``torch.distributed`` for the port: the logical-axis rule
table and the active mesh (``sharding``), the collectives DTensor cannot
place by itself (``spmd``), and a host's group of ranks (``launch``)."""
from repro_torch.distributed.sharding import (  # noqa: F401
    DEFAULT_RULES,
    ShardingRules,
    active_rules,
    current_mesh,
    named_sharding,
    shard,
    use_mesh,
)
