"""Re-export of the sharding rules (logical-axis -> mesh-axis mapping).

The implementation lives in ``repro_torch.sharding.ctx``; this module gives
the conventional import path ``repro_torch.sharding.rules``, as
``repro.sharding.rules`` does.
"""
from repro_torch.sharding.ctx import (  # noqa: F401
    ShardingRules,
    constrain,
    get_mesh,
    get_rules,
    logical_to_spec,
    spec_for,
    use_mesh,
)
