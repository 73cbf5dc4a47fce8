"""Synthetic query-stream generators for the serving benchmarks.

A :class:`QueryStream` is a time-stamped sequence of node-id queries.  Three
arrival/popularity shapes cover the workloads the serving literature
benchmarks against (BGL, arXiv 2112.08541: cache hit rate under power-law
popularity dominates GNN serving throughput):

- ``uniform`` — Poisson arrivals, uniformly popular nodes;
- ``zipf``    — Poisson arrivals, Zipf(``alpha``) node popularity (the
  skew knob; sampled by inverse CDF so the skew is *pointwise* monotone in
  ``alpha`` under a fixed seed — the property tests rely on this);
- ``bursty``  — Zipf popularity with arrivals alternating between short
  high-rate bursts and low-rate idle stretches (tail-latency stressor).

All generators are deterministic functions of their seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["QueryStream", "uniform_stream", "zipf_stream", "bursty_stream",
           "make_stream", "WORKLOAD_KINDS"]

WORKLOAD_KINDS = ("uniform", "zipf", "bursty")


@dataclasses.dataclass(frozen=True)
class QueryStream:
    kind: str
    t: np.ndarray      # [Q] float64 arrival seconds, nondecreasing, t[0]>=0
    node: np.ndarray   # [Q] int64 queried node ids

    @property
    def num_queries(self) -> int:
        return int(self.node.shape[0])

    @property
    def duration_s(self) -> float:
        return float(self.t[-1]) if self.t.size else 0.0


def _poisson_times(n_queries: int, qps: float,
                   rng: np.random.Generator) -> np.ndarray:
    gaps = rng.exponential(1.0 / max(qps, 1e-9), n_queries)
    return np.cumsum(gaps)


def _zipf_ranks(n_nodes: int, n_queries: int, alpha: float,
                rng: np.random.Generator) -> np.ndarray:
    """Inverse-CDF Zipf sampling.

    For a fixed uniform draw ``u``, the sampled rank is nonincreasing in
    ``alpha`` (higher exponent → CDF mass shifts to low ranks), so any
    top-m query share is monotone nondecreasing in ``alpha``.
    """
    w = np.arange(1, n_nodes + 1, dtype=np.float64) ** (-float(alpha))
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    u = rng.random(n_queries)
    return np.searchsorted(cdf, u, side="left").clip(0, n_nodes - 1)


def uniform_stream(n_nodes: int, n_queries: int, qps: float = 1000.0,
                   seed: int = 0) -> QueryStream:
    rng = np.random.default_rng(seed)
    t = _poisson_times(n_queries, qps, rng)
    node = rng.integers(0, n_nodes, n_queries).astype(np.int64)
    return QueryStream(kind="uniform", t=t, node=node)


def zipf_stream(n_nodes: int, n_queries: int, qps: float = 1000.0,
                alpha: float = 1.1, seed: int = 0,
                rank_to_node: np.ndarray | None = None) -> QueryStream:
    """Zipf(``alpha``) popularity.  ``rank_to_node`` maps popularity rank →
    node id (e.g. a degree ordering, so the head of the distribution lands
    on the engine's degree-ranked hot tier); default is a seeded
    permutation, decorrelating popularity from node id."""
    rng = np.random.default_rng(seed)
    t = _poisson_times(n_queries, qps, rng)
    ranks = _zipf_ranks(n_nodes, n_queries, alpha, rng)
    if rank_to_node is None:
        rank_to_node = np.random.default_rng(seed + 1).permutation(n_nodes)
    node = np.asarray(rank_to_node, np.int64)[ranks]
    return QueryStream(kind="zipf", t=t, node=node)


def bursty_stream(n_nodes: int, n_queries: int, qps: float = 1000.0,
                  alpha: float = 1.1, burst_len: int = 32,
                  burst_factor: float = 16.0, seed: int = 0,
                  rank_to_node: np.ndarray | None = None) -> QueryStream:
    """Bursts of ``burst_len`` queries at ``qps * burst_factor`` separated
    by idle stretches at ``qps / burst_factor`` (mean rate stays ~``qps``
    for burst_factor >> 1 with equal on/off query counts)."""
    rng = np.random.default_rng(seed)
    in_burst = (np.arange(n_queries) // max(1, burst_len)) % 2 == 0
    rate = np.where(in_burst, qps * burst_factor, qps / burst_factor)
    gaps = rng.exponential(1.0, n_queries) / np.maximum(rate, 1e-9)
    t = np.cumsum(gaps)
    ranks = _zipf_ranks(n_nodes, n_queries, alpha, rng)
    if rank_to_node is None:
        rank_to_node = np.random.default_rng(seed + 1).permutation(n_nodes)
    node = np.asarray(rank_to_node, np.int64)[ranks]
    return QueryStream(kind="bursty", t=t, node=node)


def make_stream(kind: str, n_nodes: int, n_queries: int, qps: float = 1000.0,
                alpha: float = 1.1, seed: int = 0,
                rank_to_node: np.ndarray | None = None) -> QueryStream:
    """Dispatcher used by the CLI / benchmarks."""
    if kind == "uniform":
        return uniform_stream(n_nodes, n_queries, qps, seed)
    if kind == "zipf":
        return zipf_stream(n_nodes, n_queries, qps, alpha, seed, rank_to_node)
    if kind == "bursty":
        return bursty_stream(n_nodes, n_queries, qps, alpha, seed=seed,
                             rank_to_node=rank_to_node)
    raise ValueError(f"unknown workload kind {kind!r}; "
                     f"expected one of {WORKLOAD_KINDS}")
