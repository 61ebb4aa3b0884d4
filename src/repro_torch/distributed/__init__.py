"""repro_torch.distributed — the sharded tier: ring collectives and the
sharded DAGM, on one device's agent ring (`LocalRing`) or on a
`torch.distributed` process ring (`ProcessRing`).

Also the logical-axis sharding rules of the model zoo (`sharding`:
`ShardingRules`, `make_rules`, `use_rules`, `shard`, ...) on a
`DeviceMesh`.  Counterpart of `repro.distributed` (its `shard_map` shim
is JAX-only).
"""
from .collectives import (LocalRing, ProcessRing, RingWeights,
                          ring_laplacian, ring_laplacian_c, ring_mix,
                          ring_mix_c, ring_shift, tadd, taxpy, tdot, tnorm,
                          tscale, tsub)
from .dagm_sharded import (ShardedRoundCoeffs, dagm_local_round,
                           make_sharded_dagm, open_sharded_channels,
                           round_channels, sharded_comm_ledger,
                           sharded_policy, sharded_round_coeffs)
from .sharding import (ShardingRules, current_rules, make_rules, shard,
                       tree_param_sharding, use_rules)

__all__ = [
    "LocalRing", "ProcessRing", "RingWeights", "ShardedRoundCoeffs",
    "ShardingRules", "current_rules", "make_rules", "shard",
    "tree_param_sharding", "use_rules",
    "dagm_local_round", "make_sharded_dagm",
    "open_sharded_channels", "ring_laplacian",
    "ring_laplacian_c", "ring_mix", "ring_mix_c", "ring_shift",
    "round_channels", "sharded_comm_ledger", "sharded_policy",
    "sharded_round_coeffs", "tadd", "taxpy", "tdot", "tnorm", "tscale",
    "tsub",
]
