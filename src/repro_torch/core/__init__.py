"""CaPGNN core planning: device profiles and JACA cache capacity/plans."""
from .device_profile import (DeviceProfile, PROFILES, PAPER_GROUPS,
                             make_group, detect_host_mem_gib)
from .jaca import (CacheCapacity, cal_capacity, CachePlan, WorkerCachePlan,
                   build_cache_plan)

__all__ = [
    "DeviceProfile", "PROFILES", "PAPER_GROUPS", "make_group",
    "detect_host_mem_gib",
    "CacheCapacity", "cal_capacity", "CachePlan", "WorkerCachePlan",
    "build_cache_plan",
]
