"""Distribution layer on ``torch.distributed`` (counterpart of
``repro.distributed``): sharding rules, pipeline parallelism, the
collectives over a mesh axis, and the SUMMA sharded GEMM."""
from repro_torch.distributed.sharding import (MeshRules, logical_spec,
                                              rules_for, shard,
                                              spec_tree_to_shardings,
                                              use_rules)
from repro_torch.distributed.summa import (sma_gemm_sharded,
                                           summa_comm_stats, summa_grid,
                                           summa_schedule)

__all__ = ["MeshRules", "logical_spec", "rules_for", "shard",
           "spec_tree_to_shardings", "use_rules",
           "sma_gemm_sharded", "summa_comm_stats", "summa_grid",
           "summa_schedule"]
