"""JACA — Joint Adaptive Caching Algorithm (paper §4.2, Alg. 1, Eq. 2).

Two-level cache for halo vertex features/embeddings: a per-worker
**local** cache (device resident, capacity ``C_GPU[i]``) and a shared
**global** cache (host resident in the paper, capacity ``C_CPU``).
Full-batch passes touch every halo vertex, so candidates are ranked by the
static *vertex overlap ratio* R(v) (Eq. 2) and the ranking is compiled into
a :class:`CachePlan`: per worker, the halo set split into ``local``,
``global`` and ``uncached`` tiers.

**Online adaptation** (paper §4.2 "lightweight cache update"):
:class:`AdaptivePlanner` makes the tiering a runtime object.  It ingests
per-halo access observations (and, for the ``drift`` policy, the per-row
staleness drift the runtimes measure), evolves FIFO/LRU/EWMA eviction
state live, and ``replan()`` materialises it as a fresh :class:`CachePlan`;
compiled against a capacity-padded (slot-stable) exchange layout, every
re-plan has the same tensor shapes, so a runtime swaps it in as data.
FIFO/LRU baselines (paper Figs. 15-16) are also trace-simulated over the
epoch access stream (:func:`simulate_policy_hit_rate`).

A numpy copy of the JAX package's ``core/jaca.py`` (byte-identical plans,
hit rates and re-plans for the same inputs: the same RNG calls on the same
seeds).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Literal, Sequence

import numpy as np

from ..graph.partition import PartitionSet
from .device_profile import DeviceProfile, detect_host_mem_gib

__all__ = ["CacheCapacity", "cal_capacity", "CachePlan", "WorkerCachePlan",
           "build_cache_plan", "plan_hit_rate", "simulate_policy_hit_rate",
           "comm_bytes_per_step", "AdaptivePlanner", "plan_from_membership",
           "ADAPTIVE_POLICIES"]

Policy = Literal["overlap_high", "overlap_low", "random", "fifo", "lru"]

# runtime (online) eviction policies the AdaptivePlanner understands;
# "static" freezes the initial overlap plan (the paper's JACA baseline)
ADAPTIVE_POLICIES = ("static", "overlap", "fifo", "lru", "drift")


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


def plan_hit_rate(plan: CachePlan) -> dict:
    """Exact hit rates of a static plan over one epoch (every halo touched).

    A 'hit' = halo access served from a cache tier instead of communicated.
    On refresh steps cached tiers are also communicated; the *amortised*
    hit rate accounts for that via refresh_every.
    """
    n_local = sum(w.local_pos.size for w in plan.workers)
    n_global = sum(w.global_pos.size for w in plan.workers)
    n_un = sum(w.uncached_pos.size for w in plan.workers)
    total = max(1, n_local + n_global + n_un)
    tau = plan.refresh_every
    amortised = (n_local + n_global) * (1.0 - 1.0 / max(1, tau)) / total
    return {
        "local_hit": n_local / total,
        "global_hit": n_global / total,
        "hit": (n_local + n_global) / total,
        "amortised_hit": amortised,
        "miss": n_un / total,
    }


# ---------------------------------------------------------------------------
# Dynamic policy baselines (FIFO / LRU) over the epoch access stream
# ---------------------------------------------------------------------------

def _epoch_stream(ps: PartitionSet, layers: int, seed: int) -> np.ndarray:
    """Access stream of one epoch: per layer, every partition touches all of
    its halo vertices (vertex-id order within partition, as the aggregation
    sweep does)."""
    rng = np.random.default_rng(seed)
    chunks = []
    for _ in range(layers):
        for part in ps.parts:
            chunks.append(part.halo_nodes)
    return np.concatenate(chunks) if chunks else np.zeros(0, np.int64)


def simulate_policy_hit_rate(ps: PartitionSet, capacity: int,
                             policy: Policy = "lru", layers: int = 3,
                             epochs: int = 3, seed: int = 0) -> float:
    """Trace-simulate FIFO/LRU (and the static policies for comparison) on
    the epoch access stream; returns overall hit rate (paper Fig. 15)."""
    stream = _epoch_stream(ps, layers, seed)
    if stream.size == 0:
        return 0.0
    if policy in ("overlap_high", "overlap_low", "random"):
        overlap = ps.overlap_ratio()
        uniq = np.unique(stream)
        pri = overlap[uniq].astype(float)
        rng = np.random.default_rng(seed)
        if policy == "overlap_high":
            order = np.argsort(-pri, kind="stable")
        elif policy == "overlap_low":
            order = np.argsort(pri, kind="stable")
        else:
            order = rng.permutation(uniq.size)
        cached = set(int(v) for v in uniq[order][:capacity])
        hits = sum(1 for _ in range(epochs) for v in stream if int(v) in cached)
        return hits / (epochs * stream.size)
    hits = 0
    if policy == "fifo":
        cache: set[int] = set()
        fifo: deque[int] = deque()
        for _ in range(epochs):
            for v in stream:
                v = int(v)
                if v in cache:
                    hits += 1
                else:
                    if len(cache) >= capacity and fifo:
                        cache.discard(fifo.popleft())
                    cache.add(v)
                    fifo.append(v)
    elif policy == "lru":
        lru: OrderedDict[int, None] = OrderedDict()
        for _ in range(epochs):
            for v in stream:
                v = int(v)
                if v in lru:
                    hits += 1
                    lru.move_to_end(v)
                else:
                    if len(lru) >= capacity:
                        lru.popitem(last=False)
                    lru[v] = None
    else:
        raise ValueError(policy)
    return hits / (epochs * stream.size)


def comm_bytes_per_step(plan: CachePlan, feat_dim: int,
                        dtype_bytes: int = 4) -> dict:
    """Exact communication volume implied by a plan (per training step).

    cached step: only uncached halos move.
    refresh step: all halos move (uncached + both cache tiers refresh), but
    global-tier rows are deduplicated — one broadcast row per unique
    *consumed* vertex instead of one copy per consumer partition (resident
    rows no worker reads are never refreshed).  These figures follow the
    paper's point-to-point transport model and equal the row counts of the
    compiled exchange plan's index sets
    (``repro_torch.dist.ExchangePlan.bytes_per_step``, asserted by the tier-1
    suite).  The SPMD runtime's ``transport="p2p"`` (per-peer packed
    ``ppermute`` blocks) ships exactly these rows on the wire; only the
    legacy ``transport="allgather"`` broadcast moves more (~P x).
    ``dtype_bytes`` must be the actual halo payload width — 4 for f32,
    2 when the runtimes run with ``halo_dtype="bf16"``.
    """
    n_un = sum(w.uncached_pos.size for w in plan.workers)
    n_local = sum(w.local_pos.size for w in plan.workers)
    used_global = [w.global_gids for w in plan.workers if w.global_gids.size]
    n_global_dedup = (int(np.unique(np.concatenate(used_global)).size)
                      if used_global else 0)
    row = feat_dim * dtype_bytes
    cached_step = n_un * row
    refresh_step = (n_un + n_local + n_global_dedup) * row
    tau = max(1, plan.refresh_every)
    amortised = (cached_step * (tau - 1) + refresh_step) / tau
    no_cache = (n_un + n_local + sum(w.global_pos.size for w in plan.workers)) * row
    return {
        "cached_step_bytes": cached_step,
        "refresh_step_bytes": refresh_step,
        "amortised_bytes": amortised,
        "no_cache_bytes": no_cache,
        "reduction": 1.0 - amortised / max(1, no_cache),
    }


# ---------------------------------------------------------------------------
# Online adaptation: live eviction state -> re-ranked cache plans
# ---------------------------------------------------------------------------

def plan_from_membership(ps: PartitionSet, local_sets: Sequence[set],
                         global_set: set, capacity: CacheCapacity,
                         refresh_every: int) -> CachePlan:
    """Assemble a :class:`CachePlan` from explicit tier membership.

    ``local_sets[i]`` is worker ``i``'s local-cache gid set (must fit
    ``c_gpu[i]``), ``global_set`` the shared residency (must fit
    ``c_cpu``).  Per worker: halo positions whose gid is locally resident
    form the local tier; of the rest, those globally resident form the
    global tier; everything else is uncached — the same local-first
    priority :func:`build_cache_plan` applies.
    """
    workers: list[WorkerCachePlan] = []
    for i, part in enumerate(ps.parts):
        if len(local_sets[i]) > capacity.c_gpu[i]:
            raise ValueError(
                f"worker {i} local membership {len(local_sets[i])} exceeds "
                f"capacity {capacity.c_gpu[i]}")
        gids = part.halo_nodes
        pos = np.arange(part.n_halo)
        in_local = np.fromiter((int(v) in local_sets[i] for v in gids),
                               bool, count=part.n_halo) \
            if part.n_halo else np.zeros(0, bool)
        in_global = np.fromiter(
            (int(v) in global_set for v in gids), bool,
            count=part.n_halo) & ~in_local if part.n_halo \
            else np.zeros(0, bool)
        un = ~(in_local | in_global)
        workers.append(WorkerCachePlan(
            part_id=i,
            local_pos=pos[in_local], global_pos=pos[in_global],
            uncached_pos=pos[un],
            local_gids=gids[in_local], global_gids=gids[in_global],
            uncached_gids=gids[un]))
    if len(global_set) > capacity.c_cpu:
        raise ValueError(f"global membership {len(global_set)} exceeds "
                         f"capacity {capacity.c_cpu}")
    global_gids = np.array(sorted(int(v) for v in global_set), np.int64)
    return CachePlan(workers=workers, capacity=capacity,
                     global_gids=global_gids, refresh_every=refresh_every)


class _StreamCache:
    """Live FIFO/LRU eviction state over a gid access stream.

    ``access`` mirrors :func:`simulate_policy_hit_rate`'s trace loop
    statement-for-statement, so a planner fed the same epoch stream
    reproduces the simulator's hit sequence exactly (asserted by the
    tier-1 suite).  Capacity 0 disables the cache (always miss, no
    insert)."""

    def __init__(self, capacity: int, policy: str):
        if policy not in ("fifo", "lru"):
            raise ValueError(policy)
        self.capacity = int(capacity)
        self.policy = policy
        self._fifo: deque[int] = deque()
        self._set: set[int] = set()
        self._lru: OrderedDict[int, None] = OrderedDict()

    def access(self, v: int) -> bool:
        if self.capacity <= 0:
            return False
        if self.policy == "fifo":
            if v in self._set:
                return True
            if len(self._set) >= self.capacity and self._fifo:
                self._set.discard(self._fifo.popleft())
            self._set.add(v)
            self._fifo.append(v)
            return False
        if v in self._lru:
            self._lru.move_to_end(v)
            return True
        if len(self._lru) >= self.capacity:
            self._lru.popitem(last=False)
        self._lru[v] = None
        return False

    def resident(self) -> set:
        return set(self._set) if self.policy == "fifo" else set(self._lru)

    def resize(self, capacity: int) -> None:
        """Shrink (or grow) the live capacity, evicting in policy order —
        the memory-pressure backoff path
        (:meth:`AdaptivePlanner.shrink_capacity`)."""
        self.capacity = max(0, int(capacity))
        if self.policy == "fifo":
            while len(self._set) > self.capacity and self._fifo:
                self._set.discard(self._fifo.popleft())
        else:
            while len(self._lru) > self.capacity:
                self._lru.popitem(last=False)


@dataclasses.dataclass
class AdaptivePlanner:
    """Online cache adaptation: turn runtime access/drift observations into
    re-ranked :class:`CachePlan`\\ s at refresh boundaries.

    Policies (``--cache-policy`` in the launcher):

    - ``static``  — never re-ranks; :meth:`replan` returns the initial
      overlap plan unchanged (the paper's frozen JACA baseline);
    - ``overlap`` — re-runs the Eq. 2 overlap ranking (a no-op re-plan on
      a static graph: exercises the slot-stable swap path end-to-end);
    - ``fifo`` / ``lru`` — live eviction state per worker-local cache plus
      the shared global cache, exactly the trace semantics of
      :func:`simulate_policy_hit_rate`; :meth:`replan` materialises the
      current residents;
    - ``drift``   — ranks by an exponentially-weighted access frequency
      damped by the measured per-row staleness drift
      (``score = ewma_freq / (1 + drift_weight * ewma_drift)``): hot rows
      whose stale values stay accurate are the cheapest to cache under
      bounded staleness.

    The planner is pure numpy/python — observation costs are off the
    device step path, matching the paper's "lightweight cache update"
    claim.
    """
    ps: PartitionSet
    capacity: CacheCapacity
    refresh_every: int = 4
    policy: str = "lru"
    seed: int = 0
    decay: float = 0.8          # EWMA decay for access frequency / drift
    drift_weight: float = 1.0

    def __post_init__(self):
        if self.policy not in ADAPTIVE_POLICIES:
            raise ValueError(f"unknown adaptive policy {self.policy!r}; "
                             f"expected one of {ADAPTIVE_POLICIES}")
        n = self.ps.graph.num_nodes
        union = self.ps.halo_union()
        self.plan = build_cache_plan(self.ps, self.capacity,
                                     refresh_every=self.refresh_every,
                                     policy="overlap_high", seed=self.seed)
        self._initial = self.plan
        if self.policy in ("fifo", "lru"):
            self._local = [
                _StreamCache(min(self.capacity.c_gpu[i], pt.n_halo),
                             self.policy)
                for i, pt in enumerate(self.ps.parts)]
            self._global = _StreamCache(min(self.capacity.c_cpu, union.size),
                                        self.policy)
        else:
            self._local, self._global = None, None
        self._freq = np.zeros(n, np.float64)     # EWMA access frequency
        self._vdrift = np.zeros(n, np.float64)   # EWMA per-row value drift
        self._hits = 0
        self._accesses = 0
        self._steps = 0
        self._sync_membership()

    # -- observation ------------------------------------------------------

    def _sync_membership(self) -> None:
        self._local_sets = [set(int(v) for v in w.local_gids)
                            for w in self.plan.workers]
        self._global_plan_set = set()
        for w in self.plan.workers:
            self._global_plan_set.update(int(v) for v in w.global_gids)
        # sorted arrays for vectorized membership tests in observe_step
        self._local_sorted = [np.sort(w.local_gids)
                              for w in self.plan.workers]
        self._global_sorted = np.array(
            sorted(self._global_plan_set), np.int64)

    def observe_step(self, accessed: Sequence[np.ndarray] | None = None,
                     layers: int = 1) -> dict:
        """Ingest one step's halo accesses.

        ``accessed[i]`` is the gid array worker ``i`` touched (default: its
        full halo — exact for full-batch training, where every layer sweeps
        every halo vertex).  Per layer, workers are visited in partition
        order — the same stream order :func:`_epoch_stream` replays.
        Returns this call's ``{"accesses", "hits"}`` (cumulative counters
        feed :meth:`hit_rate`).  Hits are counted against the *live*
        eviction state for fifo/lru (simulator semantics) and against the
        installed plan's tiers for the plan-ranked policies.
        """
        if accessed is None:
            accessed = [pt.halo_nodes for pt in self.ps.parts]
        hits = accesses = 0
        decay_once = True
        for _ in range(max(1, layers)):
            for i, gids in enumerate(accessed):
                gids = np.asarray(gids)
                accesses += gids.size
                if self.policy in ("fifo", "lru"):
                    # per-access loop is load-bearing: the eviction state
                    # must evolve in stream order to stay bit-exact with
                    # the trace simulator
                    loc, glob = self._local[i], self._global
                    for v in gids:
                        v = int(v)
                        if loc.access(v):
                            hits += 1
                        elif glob.access(v):
                            hits += 1
                elif gids.size:
                    hit_mask = (np.isin(gids, self._local_sorted[i])
                                | np.isin(gids, self._global_sorted))
                    hits += int(hit_mask.sum())
            if decay_once:
                # EWMA frequency update: one decay per observed step, then
                # accumulate this step's multiplicity
                self._freq *= self.decay
                decay_once = False
            for gids in accessed:
                gids = np.asarray(gids)
                if gids.size:
                    np.add.at(self._freq, gids, 1.0)
        self._hits += hits
        self._accesses += accesses
        self._steps += 1
        return {"accesses": accesses, "hits": hits}

    def observe_drift(self, local_rows: np.ndarray,
                      global_rows: np.ndarray) -> None:
        """Fold a refresh step's per-row staleness drift (the runtimes'
        ``drift_local_rows [P, R]`` / ``drift_global_rows [G]`` metrics)
        into the per-vertex EWMA the ``drift`` policy ranks by.  Row order
        follows the *installed* plan: worker ``i``'s local rows are
        ``plan.workers[i].local_gids``; buffer rows are the sorted unique
        consumed global gids."""
        local_rows = np.asarray(local_rows, np.float64)
        self._vdrift *= self.decay
        for i, w in enumerate(self.plan.workers):
            k = w.local_gids.size
            if k:
                np.maximum.at(self._vdrift, w.local_gids,
                              (1 - self.decay) * local_rows[i, :k])
        used = [w.global_gids for w in self.plan.workers
                if w.global_gids.size]
        if used:
            buf_gids = np.unique(np.concatenate(used))
            rows = np.asarray(global_rows, np.float64)[: buf_gids.size]
            np.maximum.at(self._vdrift, buf_gids, (1 - self.decay) * rows)

    # -- re-planning ------------------------------------------------------

    def _ranked_plan(self, score: np.ndarray) -> CachePlan:
        """Top-score tiering under the capacity constraints (ties broken
        by gid for determinism)."""
        union = self.ps.halo_union()
        local_sets = []
        for i, pt in enumerate(self.ps.parts):
            gids = pt.halo_nodes
            c = min(self.capacity.c_gpu[i], pt.n_halo)
            order = np.argsort(-score[gids], kind="stable")
            local_sets.append(set(int(v) for v in gids[order[:c]]))
        c_cpu = min(self.capacity.c_cpu, union.size)
        order = np.argsort(-score[union], kind="stable")
        global_set = set(int(v) for v in union[order[:c_cpu]])
        return plan_from_membership(self.ps, local_sets, global_set,
                                    self.capacity, self.refresh_every)

    def replan(self) -> CachePlan:
        """Materialise the current eviction/ranking state as a new plan
        (and install it as the planner's reference membership)."""
        if self.policy == "static":
            return self.plan
        if self.policy == "overlap":
            new = build_cache_plan(self.ps, self.capacity,
                                   refresh_every=self.refresh_every,
                                   policy="overlap_high", seed=self.seed)
        elif self.policy in ("fifo", "lru"):
            local_sets = [c.resident() for c in self._local]
            glob = self._global.resident()
            new = plan_from_membership(self.ps, local_sets, glob,
                                       self.capacity, self.refresh_every)
        else:  # drift
            score = self._freq / (1.0 + self.drift_weight * self._vdrift)
            new = self._ranked_plan(score)
        self.plan = new
        self._sync_membership()
        return new

    def exchange_plan(self, plan: CachePlan | None = None):
        """Compile ``plan`` (default: the installed one) against the
        planner's slot-stable capacity padding — every plan this planner
        emits shares one shape signature, so a swap changes the runtime's
        index data, never its tensor shapes."""
        from ..dist.exchange import build_exchange_plan, exchange_capacity
        if not hasattr(self, "_pad"):
            self._pad = exchange_capacity(self.ps, self.capacity)
        return build_exchange_plan(self.ps, plan or self.plan,
                                   pad_to=self._pad)

    def shrink_capacity(self, factor: float) -> CacheCapacity:
        """Memory-pressure backoff (the fault slice's defense, driven by
        ``train_capgnn`` under ``mem_pressure``): scale every cache budget
        by ``factor`` and rebuild the
        planner state under the smaller budget, so the next
        :meth:`replan` emits a plan that fits.  The exchange padding is
        pinned to the *pre-shrink* capacity first — shrunk plans keep the
        original slot-stable shape signature."""
        if not 0.0 < factor <= 1.0:
            raise ValueError(f"shrink factor must be in (0, 1], "
                             f"got {factor}")
        from ..dist.exchange import exchange_capacity
        if not hasattr(self, "_pad"):
            self._pad = exchange_capacity(self.ps, self.capacity)
        self.capacity = CacheCapacity(
            c_gpu=[int(c * factor) for c in self.capacity.c_gpu],
            c_cpu=int(self.capacity.c_cpu * factor))
        if self.policy in ("fifo", "lru"):
            union = self.ps.halo_union()
            for i, pt in enumerate(self.ps.parts):
                self._local[i].resize(min(self.capacity.c_gpu[i],
                                          pt.n_halo))
            self._global.resize(min(self.capacity.c_cpu, union.size))
        if self.policy == "static":
            # static replan() returns the installed plan unchanged, so
            # the shrink must rebuild it here to be load-bearing
            self.plan = build_cache_plan(self.ps, self.capacity,
                                         refresh_every=self.refresh_every,
                                         policy="overlap_high",
                                         seed=self.seed)
            self._sync_membership()
        return self.capacity

    def hit_rate(self) -> float:
        """Cumulative hit rate over every observed access."""
        return self._hits / max(1, self._accesses)

    def counters(self) -> dict:
        """Snapshot of the cumulative hit accounting in the
        tracing schema — what the tracer's per-step
        ``planner_hit_rate`` counter track is derived from."""
        return {"hits": int(self._hits), "accesses": int(self._accesses),
                "steps": int(self._steps), "hit_rate": self.hit_rate()}
