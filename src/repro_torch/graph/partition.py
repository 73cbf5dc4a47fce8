"""Graph partitioners and halo construction.

Three partitioners, mirroring the paper's experimental setup (§3.4 uses
METIS and Random; §2.4 also discusses streaming partitioners):

- ``random_partition``  — uniform random vertex assignment (paper baseline)
- ``fennel_partition``  — single-pass streaming with locality-balance objective
- ``metis_partition``   — METIS-like multilevel: heavy-edge-matching
  coarsening, greedy initial partition, boundary Kernighan-Lin refinement.

``build_partition`` then materialises, per part: inner vertices, k-hop halo
sets, local CSR (inner rows x (inner+halo) cols) and the ownership maps the
distributed runtime needs.  Vertex-centric (edge-cut) partitioning with halo
retention, as in paper Fig. 2.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .graph import Graph, csr_from_edges

__all__ = [
    "Partition", "PartitionSet", "random_partition", "fennel_partition",
    "metis_partition", "build_partition", "edge_cut",
]


def random_partition(g: Graph, parts: int, seed: int = 0,
                     weights: Sequence[float] | None = None) -> np.ndarray:
    """Random assignment, optionally with target fractions per part."""
    rng = np.random.default_rng(seed)
    if weights is None:
        return rng.integers(0, parts, size=g.num_nodes).astype(np.int32)
    w = np.asarray(weights, dtype=np.float64)
    w = w / w.sum()
    return rng.choice(parts, size=g.num_nodes, p=w).astype(np.int32)


def fennel_partition(g: Graph, parts: int, seed: int = 0, gamma: float = 1.5,
                     weights: Sequence[float] | None = None) -> np.ndarray:
    """Fennel streaming partitioner (Tsourakakis et al., 2014).

    Greedy per-vertex placement maximising |neighbours in part| - penalty,
    with the balance penalty alpha * gamma * (size)^(gamma-1), optionally
    scaled by per-part capacity weights (used by RAPA's capability-aware
    pre-partition).
    """
    rng = np.random.default_rng(seed)
    n, m = g.num_nodes, g.num_edges
    w = np.ones(parts) / parts if weights is None else np.asarray(weights, float) / np.sum(weights)
    alpha = np.sqrt(parts) * m / max(1.0, n ** gamma)
    assign = -np.ones(n, dtype=np.int32)
    sizes = np.zeros(parts, dtype=np.int64)
    order = rng.permutation(n)
    cap = w * n
    for v in order:
        nbr = g.neighbors(v)
        nb_assign = assign[nbr]
        gain = np.zeros(parts)
        valid = nb_assign[nb_assign >= 0]
        if valid.size:
            np.add.at(gain, valid, 1.0)
        # capacity-normalised balance penalty
        rel = sizes / np.maximum(cap, 1.0)
        penalty = alpha * gamma * rel ** (gamma - 1.0)
        p = int(np.argmax(gain - penalty))
        assign[v] = p
        sizes[p] += 1
    if weights is None:
        return assign
    return _rebalance(g, assign, parts, w * n)


def _heavy_edge_matching(g: Graph, rng: np.random.Generator) -> np.ndarray:
    """Return coarse-node id per node via randomized heavy-edge matching."""
    n = g.num_nodes
    match = -np.ones(n, dtype=np.int64)
    order = rng.permutation(n)
    for v in order:
        if match[v] >= 0:
            continue
        best = -1
        for u in g.neighbors(v):
            if match[u] < 0 and u != v:
                best = u
                break
        if best >= 0:
            match[v] = best
            match[best] = v
        else:
            match[v] = v
    # assign coarse ids
    coarse = -np.ones(n, dtype=np.int64)
    nxt = 0
    for v in range(n):
        if coarse[v] < 0:
            coarse[v] = nxt
            coarse[match[v]] = nxt
            nxt += 1
    return coarse


def _coarsen(g: Graph, coarse: np.ndarray) -> Graph:
    src, dst = g.edges()
    cs, cd = coarse[src], coarse[dst]
    keep = cs != cd
    nc = int(coarse.max()) + 1
    return csr_from_edges(cs[keep], cd[keep], nc, dedup=True)


def _greedy_grow(g: Graph, parts: int, rng: np.random.Generator,
                 weights: np.ndarray) -> np.ndarray:
    """Greedy BFS region growing for the initial (coarsest) partition."""
    n = g.num_nodes
    assign = -np.ones(n, dtype=np.int32)
    target = weights * n
    sizes = np.zeros(parts)
    seeds = rng.choice(n, size=min(parts, n), replace=False)
    from collections import deque
    queues = [deque([s]) for s in seeds]
    for p, s in enumerate(seeds):
        assign[s] = p
        sizes[p] += 1
    active = True
    while active:
        active = False
        for p in range(min(parts, n)):
            if sizes[p] >= target[p]:
                continue
            q = queues[p]
            while q:
                v = q.popleft()
                placed = False
                for u in g.neighbors(v):
                    if assign[u] < 0:
                        assign[u] = p
                        sizes[p] += 1
                        q.append(u)
                        placed = True
                        active = True
                        break
                if placed:
                    break
    # orphans -> least loaded (relative to target)
    for v in np.where(assign < 0)[0]:
        p = int(np.argmin(sizes / np.maximum(target, 1e-9)))
        assign[v] = p
        sizes[p] += 1
    return assign


def _refine(g: Graph, assign: np.ndarray, parts: int, weights: np.ndarray,
            passes: int = 3, imbalance: float = 1.05) -> np.ndarray:
    """Boundary refinement (KL/FM-style single-vertex moves)."""
    assign = assign.copy()
    n = g.num_nodes
    target = weights * n
    sizes = np.bincount(assign, minlength=parts).astype(np.float64)
    for _ in range(passes):
        moved = 0
        src, dst = g.edges()
        boundary = np.unique(src[assign[src] != assign[dst]])
        for v in boundary:
            nbr = g.neighbors(v)
            if nbr.size == 0:
                continue
            counts = np.bincount(assign[nbr], minlength=parts)
            cur = assign[v]
            best = int(np.argmax(counts))
            if best == cur or counts[best] <= counts[cur]:
                continue
            if sizes[best] + 1 > imbalance * target[best]:
                continue
            assign[v] = best
            sizes[cur] -= 1
            sizes[best] += 1
            moved += 1
        if moved == 0:
            break
    return assign


def _rebalance(g: Graph, assign: np.ndarray, parts: int, target: np.ndarray,
               imbalance: float = 1.05, passes: int = 8) -> np.ndarray:
    """Enforce per-part size caps ``imbalance * target`` by migrating the
    least internally-connected vertices of overfull parts into the
    highest-affinity part with room.

    Greedy growth and KL refinement only *avoid* overfilling a part — they
    never shrink one that already overshot, so without this pass the
    partitioners track capacity ``weights`` loosely (one part can absorb
    half the graph), which defeats resource-aware uneven partitioning.

    Runs only on the explicitly-weighted path: ``weights=None`` callers
    keep the historical (balanced) partitioner output unchanged.
    """
    assign = assign.copy()
    n = g.num_nodes
    cap = np.maximum(imbalance * target, 1.0)
    for _ in range(passes):
        sizes = np.bincount(assign, minlength=parts).astype(np.float64)
        over = np.where(sizes > cap)[0]
        if over.size == 0:
            break
        # vertex -> part affinity (undirected edge counts), one snapshot
        # per pass: stale within the pass, rebuilt between passes
        src, dst = g.edges()
        cnt = np.zeros((n, parts), np.float64)
        np.add.at(cnt, (src, assign[dst]), 1.0)
        np.add.at(cnt, (dst, assign[src]), 1.0)
        moved = 0
        for po in over:
            members = np.where(assign == po)[0]
            order = members[np.argsort(cnt[members, po], kind="stable")]
            for v in order:
                if sizes[po] <= cap[po]:
                    break
                room = np.where(sizes + 1.0 <= cap)[0]
                room = room[room != po]
                if room.size == 0:
                    break
                dest = room[np.argmax(cnt[v, room])]
                assign[v] = dest
                sizes[po] -= 1.0
                sizes[dest] += 1.0
                moved += 1
        if moved == 0:
            break
    return assign.astype(np.int32)


def metis_partition(g: Graph, parts: int, seed: int = 0,
                    weights: Sequence[float] | None = None,
                    coarsen_to: int = 256) -> np.ndarray:
    """METIS-like multilevel partitioner (coarsen -> initial -> uncoarsen+refine)."""
    rng = np.random.default_rng(seed)
    w = np.ones(parts) / parts if weights is None else np.asarray(weights, float) / np.sum(weights)
    levels: list[tuple[Graph, np.ndarray]] = []
    cur = g
    while cur.num_nodes > max(coarsen_to, parts * 8):
        coarse = _heavy_edge_matching(cur, rng)
        nxt = _coarsen(cur, coarse)
        if nxt.num_nodes >= cur.num_nodes * 0.95:  # matching stalled
            break
        levels.append((cur, coarse))
        cur = nxt
    assign = _greedy_grow(cur, parts, rng, w)
    assign = _refine(cur, assign, parts, w)
    for fine, coarse in reversed(levels):
        assign = assign[coarse].astype(np.int32)
        assign = _refine(fine, assign, parts, w)
    if weights is None:
        return assign.astype(np.int32)
    assign = _rebalance(g, assign, parts, w * g.num_nodes)
    return _refine(g, assign, parts, w).astype(np.int32)


def edge_cut(g: Graph, assign: np.ndarray) -> int:
    """Unique inter-partition edges; each bidirectional pair counted once
    (paper Fig. 5 definition)."""
    src, dst = g.edges()
    cut = assign[src] != assign[dst]
    a = np.minimum(src[cut], dst[cut])
    b = np.maximum(src[cut], dst[cut])
    return int(np.unique(a.astype(np.int64) * g.num_nodes + b).shape[0])


# ---------------------------------------------------------------------------
# Partition materialisation with halo vertices
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Partition:
    """One worker's subgraph.

    Local vertex ids: ``[0, n_inner)`` are inner vertices, ``[n_inner,
    n_inner+n_halo)`` are halo vertices.  ``local_graph`` stores edges whose
    *destination* is an inner vertex (all information needed to aggregate
    into inner vertices); sources may be inner or halo.
    """
    part_id: int
    inner_nodes: np.ndarray       # [n_inner] global ids
    halo_nodes: np.ndarray        # [n_halo]  global ids (sorted)
    halo_owner: np.ndarray        # [n_halo]  owning part per halo vertex
    local_graph: Graph            # CSR over n_inner+n_halo nodes
    global_to_local: dict         # global id -> local id

    @property
    def n_inner(self) -> int:
        return int(self.inner_nodes.shape[0])

    @property
    def n_halo(self) -> int:
        return int(self.halo_nodes.shape[0])

    @property
    def n_local(self) -> int:
        return self.n_inner + self.n_halo

    def local_ids(self, global_ids: np.ndarray) -> np.ndarray:
        return np.array([self.global_to_local[int(v)] for v in global_ids],
                        dtype=np.int64)


@dataclasses.dataclass
class PartitionSet:
    """All partitions of a graph plus global bookkeeping."""
    graph: Graph
    assign: np.ndarray            # [n] part id per vertex
    parts: list[Partition]
    hops: int

    @property
    def num_parts(self) -> int:
        return len(self.parts)

    def halo_union(self) -> np.ndarray:
        """H = union of all partitions' halo sets (global ids)."""
        if not self.parts:
            return np.zeros(0, np.int64)
        return np.unique(np.concatenate([p.halo_nodes for p in self.parts]))

    def overlap_ratio(self) -> np.ndarray:
        """Paper Eq. 2: R(v) = #partitions whose halo set contains v, for all v."""
        r = np.zeros(self.graph.num_nodes, dtype=np.int32)
        for p in self.parts:
            r[p.halo_nodes] += 1
        return r

    def total_halo(self) -> int:
        return int(sum(p.n_halo for p in self.parts))

    def total_inner(self) -> int:
        return int(sum(p.n_inner for p in self.parts))


def _k_hop_halo(g_rev: Graph, inner: np.ndarray, inner_mask: np.ndarray,
                hops: int) -> np.ndarray:
    """Vertices within `hops` reverse-hops of `inner` that are not inner.

    Aggregation at an inner vertex needs its in-neighbours; stacking L layers
    needs the L-hop in-neighbourhood (paper Obs. 1 varies `hops`).
    """
    indptr, indices = g_rev.indptr, g_rev.indices
    frontier = np.asarray(inner, dtype=np.int64)
    seen = inner_mask.copy()
    halo: list[np.ndarray] = []
    for _ in range(hops):
        if frontier.size == 0:
            break
        starts = indptr[frontier]
        counts = indptr[frontier + 1] - starts
        total = int(counts.sum())
        if total == 0:
            break
        # gather every frontier vertex's neighbour list in one shot:
        # idx[k] walks starts[j] .. starts[j]+counts[j]-1 for each j
        excl = np.cumsum(counts) - counts
        idx = np.repeat(starts - excl, counts) + np.arange(total)
        nbr = indices[idx].astype(np.int64)
        new = np.unique(nbr[~seen[nbr]])
        if new.size == 0:
            break
        seen[new] = True
        halo.append(new)
        frontier = new
    if not halo:
        return np.zeros(0, np.int64)
    return np.unique(np.concatenate(halo)).astype(np.int64)


def build_partition(g: Graph, assign: np.ndarray, hops: int = 1,
                    parts: int | None = None) -> PartitionSet:
    """Materialise vertex-centric partitions with k-hop halos.

    Edges kept in partition i: every edge (u -> v) with v inner to i and u in
    (inner U halo).  This is exactly what L-layer aggregation into inner
    vertices requires when halo embeddings for layers >0 are *communicated*
    (hops=1) or replicated deeper (hops=L).

    ``parts`` fixes the number of partitions explicitly; without it the
    count is inferred as ``assign.max() + 1``, which drops trailing empty
    parts (and crashes on an empty assignment) — callers that promised a
    fleet size (e.g. ``rapa.do_partition``'s ``len(profiles) ==
    ps.num_parts`` contract) must pass it.  Empty parts materialise with
    zero inner vertices, an empty halo and an empty local graph.
    """
    assign = np.asarray(assign)
    if parts is None:
        num_parts = int(assign.max()) + 1 if assign.size else 0
    else:
        num_parts = int(parts)
        if assign.size and int(assign.max()) >= num_parts:
            raise ValueError(f"assign references part {int(assign.max())} "
                             f">= parts={num_parts}")
    g_rev = g.reverse()
    src, dst = g.edges()
    w = g.edge_weight
    parts: list[Partition] = []
    for p in range(num_parts):
        inner = np.where(assign == p)[0].astype(np.int64)
        inner_mask = np.zeros(g.num_nodes, dtype=bool)
        inner_mask[inner] = True
        halo = _k_hop_halo(g_rev, inner, inner_mask, hops)
        halo_owner = assign[halo].astype(np.int32)
        local_of = -np.ones(g.num_nodes, dtype=np.int64)
        local_of[inner] = np.arange(inner.shape[0])
        local_of[halo] = inner.shape[0] + np.arange(halo.shape[0])
        # keep edges into inner vertices whose src is local (inner or halo)
        keep = inner_mask[dst] & (local_of[src] >= 0) & (assign[dst] == p)
        lsrc, ldst = local_of[src[keep]], local_of[dst[keep]]
        lw = w[keep] if w is not None else None
        n_local = inner.shape[0] + halo.shape[0]
        lg = csr_from_edges(lsrc, ldst, n_local, weight=lw)
        g2l = {int(v): int(local_of[v]) for v in np.concatenate([inner, halo])}
        parts.append(Partition(part_id=p, inner_nodes=inner, halo_nodes=halo,
                               halo_owner=halo_owner, local_graph=lg,
                               global_to_local=g2l))
    return PartitionSet(graph=g, assign=assign.astype(np.int32), parts=parts,
                        hops=hops)
