"""CaPGNN core planning: device profiles, JACA cache capacity/plans, RAPA
partitioning, the staleness schedule and the halo analytics (numpy)."""
from .device_profile import (DeviceProfile, PROFILES, PAPER_GROUPS,
                             make_group, capability_weights,
                             detect_host_mem_gib, measure_profile)
from .jaca import (CacheCapacity, cal_capacity, CachePlan, WorkerCachePlan,
                   build_cache_plan, plan_hit_rate, simulate_policy_hit_rate,
                   comm_bytes_per_step, AdaptivePlanner, plan_from_membership,
                   ADAPTIVE_POLICIES)
from .rapa import (RapaConfig, RapaResult, comm_cost, comp_cost,
                   influence_scores, adjust_subgraph, do_partition,
                   memory_bytes, partition_lambdas)
from .staleness import StalenessController, theorem1_bound
from .halo import HaloStats, halo_stats, overlap_histogram, duplicate_count

__all__ = [
    "DeviceProfile", "PROFILES", "PAPER_GROUPS", "make_group",
    "capability_weights", "detect_host_mem_gib", "measure_profile",
    "CacheCapacity", "cal_capacity", "CachePlan", "WorkerCachePlan",
    "build_cache_plan", "plan_hit_rate", "simulate_policy_hit_rate",
    "comm_bytes_per_step", "AdaptivePlanner", "plan_from_membership",
    "ADAPTIVE_POLICIES",
    "RapaConfig", "RapaResult", "comm_cost", "comp_cost", "influence_scores",
    "adjust_subgraph", "do_partition", "memory_bytes", "partition_lambdas",
    "StalenessController", "theorem1_bound",
    "HaloStats", "halo_stats", "overlap_histogram", "duplicate_count",
]
