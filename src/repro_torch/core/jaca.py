"""JACA — Joint Adaptive Caching Algorithm (paper §4.2, Alg. 1, Eq. 2).

Two-level cache for halo vertex features/embeddings: a per-worker
**local** cache (device resident, capacity ``C_GPU[i]``) and a shared
**global** cache (host resident in the paper, capacity ``C_CPU``).
Full-batch passes touch every halo vertex, so candidates are ranked by the
static *vertex overlap ratio* R(v) (Eq. 2) and the ranking is compiled into
a :class:`CachePlan`: per worker, the halo set split into ``local``,
``global`` and ``uncached`` tiers.

A numpy copy of the capacity and plan builders of the JAX package's
``core/jaca.py`` (byte-identical plans for the same inputs).
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Sequence

import numpy as np

from ..graph.partition import PartitionSet
from .device_profile import DeviceProfile, detect_host_mem_gib

__all__ = ["CacheCapacity", "cal_capacity", "CachePlan", "WorkerCachePlan",
           "build_cache_plan"]

Policy = Literal["overlap_high", "overlap_low", "random"]


# ---------------------------------------------------------------------------
# Algorithm 1: adaptive cache capacity
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CacheCapacity:
    c_gpu: list[int]    # per-worker local-cache capacity (vertices)
    c_cpu: int          # shared global-cache capacity (vertices)


def cal_capacity(ps: PartitionSet, feat_dims: Sequence[int],
                 profiles: Sequence[DeviceProfile],
                 m_cpu_gib: float | None = None,
                 reserved_gpu_mib: float = 512.0,
                 reserved_cpu_mib: float = 1024.0,
                 top_k: int = -1,
                 reserve_partition: bool = True,
                 m_edge: int = 8) -> CacheCapacity:
    """Paper Algorithm 1 (``cal_capacity``).

    A cached vertex stores one row per layer of the feature dims in
    ``feat_dims`` (input features + per-layer embeddings), fp32.
    ``top_k`` limits candidates per partition (-1 = all halo vertices).

    ``m_cpu_gib`` budgets the shared CPU tier.  ``None`` (default) uses
    the profiles' measured ``host_mem_gib`` (the minimum across workers —
    the shared tier must fit every host), falling back to live detection
    via :func:`~repro_torch.core.device_profile.detect_host_mem_gib`; pass an
    explicit number to reproduce a fixed-budget experiment.

    ``reserve_partition=True`` sets the cache budget *jointly* with the
    partition sizes (§4.3): each worker's resident subgraph — its local
    vertices' feature/embedding rows plus ``m_edge`` bytes per local edge
    — is subtracted from device memory before the cache claims the rest,
    so with resource-aware uneven partitions big-memory devices absorb
    more cache residents and small devices don't overcommit.
    """
    if m_cpu_gib is None:
        host_gibs = [getattr(pr, "host_mem_gib", 0.0) or 0.0
                     for pr in profiles]
        if host_gibs and min(host_gibs) > 0.0:
            m_cpu_gib = float(min(host_gibs))
        else:
            m_cpu_gib = detect_host_mem_gib()
    bytes_per_vertex = float(sum(d * 4 for d in feat_dims))
    c_gpu: list[int] = []
    h_cpu: set[int] = set()
    for i, part in enumerate(ps.parts):
        n_cand = part.n_halo if top_k < 0 else min(top_k, part.n_halo)
        avail = max(0.0, profiles[i].mem_gib * 1024.0 - reserved_gpu_mib) * 1024.0 ** 2
        if reserve_partition:
            resident = (part.n_local * bytes_per_vertex
                        + part.local_graph.num_edges * float(m_edge))
            avail = max(0.0, avail - resident)
        cap = int(min(avail // bytes_per_vertex, n_cand))
        c_gpu.append(cap)
        # candidates contribute to the CPU tier's working set
        h_cpu.update(int(v) for v in part.halo_nodes[:n_cand])
    avail_cpu = max(0.0, m_cpu_gib * 1024.0 - reserved_cpu_mib) * 1024.0 ** 2
    c_cpu = int(min(avail_cpu // bytes_per_vertex, len(h_cpu)))
    return CacheCapacity(c_gpu=c_gpu, c_cpu=c_cpu)


# ---------------------------------------------------------------------------
# Cache plan (static tiering by overlap ratio)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WorkerCachePlan:
    """Tiering of one worker's halo slots.

    All index arrays are *local halo positions* in ``[0, n_halo)`` (the
    partition's halo block is local ids ``n_inner + pos``).
    """
    part_id: int
    local_pos: np.ndarray      # cached in this worker's local (HBM) cache
    global_pos: np.ndarray     # served from the shared global cache
    uncached_pos: np.ndarray   # exchanged every step
    # global ids for each tier (same order as the pos arrays)
    local_gids: np.ndarray
    global_gids: np.ndarray
    uncached_gids: np.ndarray

    @property
    def n_halo(self) -> int:
        return (self.local_pos.size + self.global_pos.size
                + self.uncached_pos.size)


@dataclasses.dataclass(frozen=True)
class CachePlan:
    workers: list[WorkerCachePlan]
    capacity: CacheCapacity
    global_gids: np.ndarray    # unique gids resident in the global cache
    refresh_every: int         # staleness period tau (1 = always fresh)

    def worker(self, i: int) -> WorkerCachePlan:
        return self.workers[i]


def build_cache_plan(ps: PartitionSet, capacity: CacheCapacity,
                     refresh_every: int = 4,
                     policy: Policy = "overlap_high",
                     seed: int = 0) -> CachePlan:
    """Split each worker's halo set into local/global/uncached tiers.

    ``overlap_high`` is JACA (paper Eq. 2 priority).  ``overlap_low`` and
    ``random`` are the ablation orderings of Fig. 14.
    """
    rng = np.random.default_rng(seed)
    overlap = ps.overlap_ratio()

    # Global tier: under JACA ('overlap_high') the C_CPU vertices with the
    # highest overlap across *all* partitions — exactly the ones whose dedup
    # saves the most (a vertex with R(v)=k would otherwise be sent k times).
    # The ablation orderings apply the same (inverted/random) priority here
    # too, so Fig. 14 compares full-policy against full-policy.
    halo_union = ps.halo_union()
    if policy == "overlap_low":
        order = np.argsort(overlap[halo_union], kind="stable")
    elif policy == "random":
        order = rng.permutation(halo_union.size)
    else:
        order = np.argsort(-overlap[halo_union], kind="stable")
    global_gids = halo_union[order][: capacity.c_cpu]
    global_set = set(int(v) for v in global_gids)

    workers: list[WorkerCachePlan] = []
    for i, part in enumerate(ps.parts):
        pos = np.arange(part.n_halo)
        gids = part.halo_nodes
        pri = overlap[gids].astype(np.float64)
        if policy == "overlap_high":
            rank = np.argsort(-pri, kind="stable")
        elif policy == "overlap_low":
            rank = np.argsort(pri, kind="stable")
        elif policy == "random":
            rank = rng.permutation(part.n_halo)
        else:
            raise ValueError(f"unknown cache policy {policy!r}; expected "
                             "'overlap_high', 'overlap_low' or 'random'")
        c_local = min(capacity.c_gpu[i], part.n_halo)
        local_sel = rank[:c_local]
        rest = rank[c_local:]
        in_global = np.array([int(gids[p]) in global_set for p in rest],
                             dtype=bool) if rest.size else np.zeros(0, bool)
        global_sel = rest[in_global]
        uncached_sel = rest[~in_global]
        workers.append(WorkerCachePlan(
            part_id=i,
            local_pos=np.sort(pos[local_sel]),
            global_pos=np.sort(pos[global_sel]),
            uncached_pos=np.sort(pos[uncached_sel]),
            local_gids=gids[np.sort(pos[local_sel])],
            global_gids=gids[np.sort(pos[global_sel])],
            uncached_gids=gids[np.sort(pos[uncached_sel])],
        ))
    return CachePlan(workers=workers, capacity=capacity,
                     global_gids=global_gids, refresh_every=refresh_every)
