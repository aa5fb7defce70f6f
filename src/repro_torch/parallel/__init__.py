"""repro_torch.parallel: mesh-aware sharding rules, collectives over a
process mesh, and PowerSGD compression, after the reference's
``repro.parallel``, on ``torch.distributed``."""

from repro_torch.parallel.sharding import (
    AxisRules, set_rules, current_rules, act_shard, logical_spec,
    param_shardings, zero1_shardings, DEFAULT_RULES, MULTIPOD_RULES,
)
