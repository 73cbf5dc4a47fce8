"""CaPGNN core planning: device profiles, JACA cache capacity/plans, RAPA
partitioning, the staleness schedule and the halo analytics (numpy)."""
from .device_profile import (DeviceProfile, PROFILES, PAPER_GROUPS,
                             make_group, capability_weights,
                             detect_host_mem_gib)
from .jaca import (CacheCapacity, cal_capacity, CachePlan, WorkerCachePlan,
                   build_cache_plan)
from .rapa import (RapaConfig, RapaResult, comm_cost, comp_cost,
                   influence_scores, adjust_subgraph, do_partition,
                   memory_bytes, partition_lambdas)
from .staleness import StalenessController, theorem1_bound
from .halo import HaloStats, halo_stats, overlap_histogram, duplicate_count

__all__ = [
    "DeviceProfile", "PROFILES", "PAPER_GROUPS", "make_group",
    "capability_weights", "detect_host_mem_gib",
    "CacheCapacity", "cal_capacity", "CachePlan", "WorkerCachePlan",
    "build_cache_plan",
    "RapaConfig", "RapaResult", "comm_cost", "comp_cost", "influence_scores",
    "adjust_subgraph", "do_partition", "memory_bytes", "partition_lambdas",
    "StalenessController", "theorem1_bound",
    "HaloStats", "halo_stats", "overlap_histogram", "duplicate_count",
]
