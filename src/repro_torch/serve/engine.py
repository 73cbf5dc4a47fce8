"""Online node-query engine over precomputed embeddings.

Serving counterpart of the JACA training cache (paper §4.2): queries follow
skewed popularity, so a small ranked subset of vertices absorbs most
reads.  The engine answers ``logits(v)`` queries from a two-tier cache:

- **hot tier** — device-resident rows of the top-``capacity`` nodes under a
  static ranking (degree or overlap ratio).  Row fetch goes through
  :func:`repro_torch.kernels.ops.gather_rows`: the hand-written row-gather
  kernel on the card.
- **host tier** — the full precomputed table behind it, held in a
  :class:`~repro_torch.dist.host_store.HostFeatureStore`; every query the
  hot tier misses is served through the store's staged fetch, timed
  separately (``host_fetch_s``).

Queries arrive through a deadline/size **micro-batcher**: a batch closes
when it reaches ``max_batch`` or when its oldest query has waited
``deadline_ms``, whichever comes first.

**Freshness** (``fresh_hops=k``): ``update_features`` marks every node
within ``num_layers`` forward hops of an update as stale; a stale query is
answered by recomputing its k-hop in-neighbourhood subgraph with current
features, substituting precomputed layer tables at the subgraph frontier
(exact for ``k >= num_layers``).

**Tracing** (:meth:`GNNServeEngine.set_tracer`, ``serve_stream(...,
tracer=)``): the query paths record ``hot_gather`` / ``host_fetch`` /
``fresh_recompute`` sub-spans inside one ``serve_batch`` span a
micro-batch, and one ``kind="serve"`` counter record a batch.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..dist.host_store import HostFeatureStore
from ..graph.graph import Graph
from ..graph.partition import PartitionSet
from ..kernels.ops import gather_rows
from ..models.gnn import EdgeListAdj, gnn_forward
from ..obs.tracer import NULL_TRACER, StepCounters, device_peak_bytes

from .precompute import EmbeddingStore
from .workload import QueryStream

__all__ = ["rank_hot_nodes", "BatchConfig", "Batch", "MicroBatcher",
           "plan_batches", "GNNServeEngine", "serve_stream",
           "HOT_RANK_POLICIES"]

HOT_RANK_POLICIES = ("degree", "overlap")


# ---------------------------------------------------------------------------
# Hot-tier planning (JACA-style static ranking)
# ---------------------------------------------------------------------------

def rank_hot_nodes(graph: Graph, capacity: int,
                   ps: PartitionSet | None = None,
                   policy: str = "degree") -> np.ndarray:
    """Top-``capacity`` node ids under a static priority ranking.

    Same idiom as :func:`repro_torch.core.jaca.build_cache_plan`: a per-node
    priority, stable descending argsort, truncate to capacity.  ``degree``
    ranks by in-degree (popular aggregation sources; needs only the graph),
    ``overlap`` by the paper's Eq. 2 overlap ratio (needs the partition
    set; vertices read by many partitions are also the ones many queries'
    neighbourhoods share).
    """
    if policy == "degree":
        _, dst = graph.edges()
        pri = np.bincount(dst, minlength=graph.num_nodes)
    elif policy == "overlap":
        if ps is None:
            raise ValueError("policy='overlap' needs the PartitionSet")
        pri = ps.overlap_ratio()
    else:
        raise ValueError(f"unknown hot-rank policy {policy!r}; "
                         f"expected one of {HOT_RANK_POLICIES}")
    order = np.argsort(-pri.astype(np.float64), kind="stable")
    return order[: max(0, int(capacity))].astype(np.int64)


# ---------------------------------------------------------------------------
# Deadline/size micro-batcher
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BatchConfig:
    max_batch: int = 64
    deadline_ms: float = 2.0

    @property
    def deadline_s(self) -> float:
        return self.deadline_ms * 1e-3


@dataclasses.dataclass(frozen=True)
class Batch:
    idx: np.ndarray      # positions into the source stream, arrival order
    close_time: float    # when the batch was sealed (same clock as offers)


class MicroBatcher:
    """Accumulate queries; seal on size or deadline.

    Invariants (property-tested): every offered query lands in exactly one
    batch, batches preserve arrival order, ``len(batch) <= max_batch``, and
    ``close_time - first_arrival <= deadline`` for every batch.
    """

    def __init__(self, cfg: BatchConfig):
        self.cfg = cfg
        self._idx: list[int] = []
        self._t0 = 0.0

    def _seal(self, close_time: float) -> Batch:
        b = Batch(idx=np.asarray(self._idx, np.int64), close_time=close_time)
        self._idx = []
        return b

    def offer(self, i: int, t: float) -> list[Batch]:
        """Register query ``i`` arriving at time ``t`` (nondecreasing).
        Returns the batches sealed by this arrival (0, 1, or — when
        ``max_batch == 1`` forces an immediate seal after a deadline seal —
        2)."""
        out: list[Batch] = []
        if self._idx and t - self._t0 >= self.cfg.deadline_s:
            # the deadline timer fired before this arrival
            out.append(self._seal(self._t0 + self.cfg.deadline_s))
        if not self._idx:
            self._t0 = t
        self._idx.append(i)
        if len(self._idx) >= self.cfg.max_batch:
            out.append(self._seal(t))
        return out

    def flush(self) -> Batch | None:
        """Seal whatever is pending (end of stream) at its deadline."""
        if not self._idx:
            return None
        return self._seal(self._t0 + self.cfg.deadline_s)


def plan_batches(times: np.ndarray, cfg: BatchConfig) -> list[Batch]:
    """Run the whole (time-sorted) arrival sequence through a batcher."""
    mb = MicroBatcher(cfg)
    batches: list[Batch] = []
    for i, t in enumerate(np.asarray(times, np.float64)):
        batches.extend(mb.offer(i, float(t)))
    tail = mb.flush()
    if tail is not None:
        batches.append(tail)
    return batches


# ---------------------------------------------------------------------------
# BFS helpers (vectorised over the edge list)
# ---------------------------------------------------------------------------

def _bfs_mask(src: np.ndarray, dst: np.ndarray, seeds: np.ndarray,
              hops: int, n: int) -> np.ndarray:
    """Nodes within ``hops`` steps of ``seeds`` along src→dst edges
    (seeds included)."""
    seen = np.zeros(n, dtype=bool)
    seen[seeds] = True
    frontier = seen.copy()
    for _ in range(hops):
        nxt = dst[frontier[src]]
        frontier = np.zeros(n, dtype=bool)
        frontier[nxt[~seen[nxt]]] = True
        if not frontier.any():
            break
        seen |= frontier
    return seen


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

class GNNServeEngine:
    """Two-tier embedding cache + k-hop fresh recompute over one store.

    ``params`` and the hot tier live on ``device``; the host tier stages
    its fetches there too.
    """

    def __init__(self, store: EmbeddingStore, params, graph: Graph,
                 hot_ids: np.ndarray, features: np.ndarray | None = None,
                 fresh_hops: int | None = None,
                 host_store: HostFeatureStore | None = None,
                 device="cuda"):
        self.store = store
        self.cfg = store.cfg
        self.params = params
        self.graph = graph
        self.device = torch.device(device)
        self.fresh_hops = (self.cfg.num_layers if fresh_hops is None
                           else int(fresh_hops))
        n = store.num_nodes
        if graph.num_nodes != n:
            raise ValueError(f"graph has {graph.num_nodes} nodes but the "
                             f"store was precomputed over {n}")
        # current input features (fresh-path layer 0); default = the
        # features the store was precomputed from
        self.features = np.array(features if features is not None
                                 else store.tables[0], np.float32)
        self._src, self._dst = graph.edges()
        self._w = (graph.edge_weight if graph.edge_weight is not None
                   else np.ones(self._src.shape[0], np.float32))
        # tiers
        self.hot_ids = np.asarray(hot_ids, np.int64)
        self.hot_slot = np.full(n, -1, np.int32)
        self.hot_slot[self.hot_ids] = np.arange(self.hot_ids.size,
                                                dtype=np.int32)
        self.hot_buf = torch.as_tensor(store.logits[self.hot_ids],
                                       device=self.device)
        # host tier: the full table lives in a HostFeatureStore (misses
        # go through its staged fetch); a shared store may be injected
        self.host_store = (host_store if host_store is not None
                           else HostFeatureStore(store.logits,
                                                 device=self.device))
        # staleness; the fresh recompute's device-resident inputs
        self.stale = np.zeros(n, dtype=bool)
        self._dev: dict = {}
        self.stats = {"queries": 0, "hot_hits": 0, "host_hits": 0,
                      "fresh_recomputes": 0, "batches": 0,
                      "rejected_queries": 0, "host_fetch_s": 0.0}
        self.tracer = NULL_TRACER

    def set_tracer(self, tracer) -> None:
        """Attach a :class:`repro_torch.obs.Tracer`: the query paths
        record ``hot_gather`` / ``host_fetch`` / ``fresh_recompute``
        sub-spans (and the host store its ``h2d_put`` copies) nested
        inside the caller's per-batch span."""
        self.tracer = tracer
        self.host_store.set_tracer(tracer)

    # -- input validation ----------------------------------------------------

    def _validate_ids(self, nodes) -> np.ndarray:
        """Reject malformed query batches before they reach the tiers.
        Rejected ids are counted in ``stats["rejected_queries"]`` and
        surfaced as a ``ValueError`` naming the offenders."""
        nodes = np.asarray(nodes)
        if nodes.ndim != 1:
            raise ValueError(f"query batch must be 1-D node ids, "
                             f"got shape {nodes.shape}")
        if not np.issubdtype(nodes.dtype, np.integer):
            raise ValueError(f"query batch must be integer node ids, "
                             f"got dtype {nodes.dtype}")
        nodes = nodes.astype(np.int64, copy=False)
        n = self.graph.num_nodes
        bad = (nodes < 0) | (nodes >= n)
        if bad.any():
            k = int(bad.sum())
            self.stats["rejected_queries"] += k
            sample = nodes[bad][:5].tolist()
            raise ValueError(
                f"query contains {k} out-of-range node id(s) "
                f"(valid range [0, {n})): {sample}")
        return nodes

    # -- freshness ---------------------------------------------------------

    def update_features(self, nodes: np.ndarray, new_feats: np.ndarray):
        """Overwrite input features; mark the forward influence cone stale
        (every node within ``num_layers`` forward hops of an update)."""
        nodes = np.asarray(nodes, np.int64)
        self.features[nodes] = np.asarray(new_feats, np.float32)
        self._dev.pop("features", None)      # the recompute re-uploads them
        affected = _bfs_mask(self._src, self._dst, nodes,
                             self.cfg.num_layers, self.graph.num_nodes)
        self.stale |= affected

    def _resident(self) -> dict:
        """The recompute's inputs on the device, uploaded at its first
        call: the edge list, the current features (uploaded again after
        an update) and the precomputed tables of layers 1 and up."""
        dev, res = self.device, self._dev
        if "src" not in res:
            res["src"] = torch.as_tensor(self._src, dtype=torch.int64,
                                         device=dev)
            res["dst"] = torch.as_tensor(self._dst, dtype=torch.int64,
                                         device=dev)
            res["w"] = torch.as_tensor(self._w, dtype=torch.float32,
                                       device=dev)
            res["tables"] = [torch.as_tensor(t, device=dev)
                             for t in self.store.tables[1:self.cfg.num_layers]]
        if "features" not in res:
            res["features"] = torch.as_tensor(self.features, device=dev)
        return res

    @torch.inference_mode()
    def _recompute(self, nodes: np.ndarray) -> np.ndarray:
        """Exact-on-the-inside k-hop recompute for ``nodes``: the
        ``fresh_hops``-hop in-neighbourhood subgraph, all layers over it
        with current features, frontier neighbours fed from the
        precomputed layer tables (layer 0: current features).  Runs the
        edge-list backend whatever the precompute backend was.

        The reverse BFS, the subgraph's edges (every edge into it, in the
        edge list's order) and its halo (sorted ids) are found on the
        engine's device, over the inputs :meth:`_resident` keeps there;
        three reads of a count reach the host."""
        n = self.graph.num_nodes
        res = self._resident()
        src, dst = res["src"], res["dst"]
        dev = self.device
        nodes_t = torch.as_tensor(nodes, device=dev)
        # a mark per node and a spare slot n that takes the writes of the
        # edges that mark nothing: every write stores True, so edges that
        # share a node need no order
        seen = torch.zeros(n, dtype=torch.bool, device=dev)
        seen[nodes_t] = True
        frontier = seen
        for _ in range(self.fresh_hops):      # reverse BFS: dst -> src
            reach = torch.zeros(n + 1, dtype=torch.bool, device=dev)
            reach[torch.where(frontier[dst], src, n)] = True
            frontier = reach[:n] & ~seen
            seen = seen | frontier
        inner = torch.nonzero(seen).squeeze(1)
        keep = torch.nonzero(seen[dst]).squeeze(1)   # edges into the subgraph
        hsrc, hdst = src[keep], dst[keep]
        in_halo = torch.zeros(n + 1, dtype=torch.bool, device=dev)
        in_halo[torch.where(seen[hsrc], n, hsrc)] = True
        halo = torch.nonzero(in_halo[:n]).squeeze(1)
        n_inner, n_halo = inner.numel(), halo.numel()
        loc = torch.full((n,), -1, dtype=torch.int64, device=dev)
        loc[inner] = torch.arange(n_inner, device=dev)
        loc[halo] = n_inner + torch.arange(n_halo, device=dev)
        adj = EdgeListAdj(loc[hsrc], loc[hdst], res["w"][keep], n_inner,
                          n_inner + n_halo)
        halo_embeds = [res["features"][halo]] + [t[halo]
                                                 for t in res["tables"]]
        logits = gnn_forward(self.cfg, self.params, adj,
                             res["features"][inner], halo_embeds)
        return logits[torch.searchsorted(inner, nodes_t)].cpu().numpy()

    # -- query paths -------------------------------------------------------

    def lookup(self, nodes: np.ndarray) -> np.ndarray:
        """Pure tiered fetch (no staleness check): hot tier via the
        row-gather kernel, host-store staged fetch for the rest (timed
        separately into ``host_fetch_s``)."""
        nodes = self._validate_ids(nodes)
        out = np.empty((nodes.size, self.cfg.out_dim), np.float32)
        slots = self.hot_slot[nodes]
        hit = slots >= 0
        if hit.any():
            with self.tracer.span("hot_gather", rows=int(hit.sum())):
                idx = torch.as_tensor(slots[hit], device=self.device)
                out[hit] = gather_rows(self.hot_buf, idx).cpu().numpy()
        if (~hit).any():
            t0 = time.perf_counter()
            with self.tracer.span("host_fetch", rows=int((~hit).sum())):
                out[~hit] = self.host_store.fetch_rows(nodes[~hit])
            self.stats["host_fetch_s"] += time.perf_counter() - t0
        self.stats["queries"] += int(nodes.size)
        self.stats["hot_hits"] += int(hit.sum())
        self.stats["host_hits"] += int((~hit).sum())
        self.stats["batches"] += 1
        return out

    def query(self, nodes: np.ndarray) -> np.ndarray:
        """Serve one micro-batch: cached tiers for clean nodes, k-hop
        fresh recompute for stale ones."""
        nodes = self._validate_ids(nodes)
        st = self.stale[nodes]
        if not st.any():
            return self.lookup(nodes)
        out = np.empty((nodes.size, self.cfg.out_dim), np.float32)
        if (~st).any():
            out[~st] = self.lookup(nodes[~st])
            self.stats["batches"] -= 1   # one logical batch, not two
        with self.tracer.span("fresh_recompute", rows=int(st.sum())):
            out[st] = self._recompute(nodes[st])
        self.stats["queries"] += int(st.sum())
        self.stats["fresh_recomputes"] += int(st.sum())
        self.stats["batches"] += 1
        return out

    def warmup(self, batch_size: int):
        """Run one lookup at the serving batch shape before any timed work,
        so the lazy kernel build and the first launch stay out of the
        timed loop (the stats are restored afterwards)."""
        nodes = self.hot_ids[:batch_size] if self.hot_ids.size else \
            np.arange(min(batch_size, self.graph.num_nodes))
        saved = dict(self.stats)
        self.lookup(np.resize(nodes, batch_size))
        self.stats = saved


# ---------------------------------------------------------------------------
# Stream serving (simulated arrival clock, measured service times)
# ---------------------------------------------------------------------------

def serve_stream(engine: GNNServeEngine, stream: QueryStream,
                 bcfg: BatchConfig, fresh: bool = True,
                 warmup: bool = True, tracer=None) -> dict:
    """Micro-batch ``stream`` through the engine and report throughput,
    latency and per-tier hit rates.

    Arrivals follow the stream's (simulated) clock; service times are
    measured wall clock on this host, and each ends with its results read
    back to the host, so it includes the device work.  Per-query latency
    = queueing in the batcher (bounded by the deadline) + queueing behind
    earlier batches + measured service time.  QPS is service throughput
    (``queries / busy_seconds``).

    ``tracer`` records one ``serve_batch`` span per micro-batch (with the
    engine's ``hot_gather``/``host_fetch``/``fresh_recompute`` sub-spans
    nested inside) and one ``kind="serve"`` counter record per batch from
    the engine's stat deltas.
    """
    tr = tracer if tracer is not None else NULL_TRACER
    if tr.enabled:
        engine.set_tracer(tr)
    batches = plan_batches(stream.t, bcfg)
    if warmup:
        # own depth-0 span: the warmup's lookups are not batch work
        with tr.span("warmup", n=int(bcfg.max_batch)):
            engine.warmup(bcfg.max_batch)
    before = dict(engine.stats)
    latency = np.zeros(stream.num_queries)
    free = 0.0
    busy = 0.0
    for bi, b in enumerate(batches):
        nodes = stream.node[b.idx]
        snap = dict(engine.stats) if tr.enabled else None
        t0 = time.perf_counter()
        with tr.span("serve_batch", step=bi, n=int(nodes.size)):
            out = engine.query(nodes) if fresh else engine.lookup(nodes)
        service = time.perf_counter() - t0
        assert out.shape == (nodes.size, engine.cfg.out_dim)
        begin = max(b.close_time, free)
        free = begin + service
        busy += service
        latency[b.idx] = free - stream.t[b.idx]
        if tr.enabled:
            db = {k: engine.stats[k] - snap[k] for k in engine.stats}
            tr.count(StepCounters(
                step=bi, kind="serve",
                queries=int(db["queries"]),
                hot_hits=int(db["hot_hits"]),
                host_hits=int(db["host_hits"]),
                fresh_recomputes=int(db["fresh_recomputes"]),
                device_peak_bytes=device_peak_bytes(engine.device)))
    q = stream.num_queries
    d = {k: engine.stats[k] - before[k] for k in engine.stats}
    served = max(1, d["queries"])
    return {
        "workload": stream.kind,
        "queries": q,
        "batches": len(batches),
        "mean_batch": q / max(1, len(batches)),
        "qps": q / max(busy, 1e-9),
        "p50_ms": float(np.percentile(latency, 50) * 1e3) if q else 0.0,
        "p99_ms": float(np.percentile(latency, 99) * 1e3) if q else 0.0,
        "hot_hit_rate": d["hot_hits"] / served,
        "host_hit_rate": d["host_hits"] / served,
        "fresh_rate": d["fresh_recomputes"] / served,
        # host-tier staged-fetch latency, separated from hot-tier service
        "host_fetch_ms": d["host_fetch_s"] * 1e3,
        "host_fetch_per_row_ms": (d["host_fetch_s"] / d["host_hits"] * 1e3
                                  if d["host_hits"] else 0.0),
        "busy_s": busy,
    }
