"""Core graph data structures (CSR) used throughout the framework.

All host-side graph manipulation (partitioning, halo analysis, cache
planning) is done with numpy on CSR structures; device-side aggregation uses
either dense normalized adjacency (tiny graphs / tests) or blocked-ELL
packing (see :mod:`repro_torch.kernels.ell_spmm`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["Graph", "csr_from_edges", "symmetric_normalize", "subgraph"]


@dataclasses.dataclass(frozen=True)
class Graph:
    """A directed graph in CSR format.

    ``indptr[i]:indptr[i+1]`` indexes the out-neighbours of vertex ``i`` in
    ``indices``.  ``edge_weight`` is optional (defaults to 1.0).
    """

    indptr: np.ndarray          # [n+1] int64
    indices: np.ndarray         # [m] int32 column (destination) ids
    num_nodes: int
    edge_weight: Optional[np.ndarray] = None  # [m] float32 or None

    def __post_init__(self):
        assert self.indptr.ndim == 1 and self.indptr.shape[0] == self.num_nodes + 1
        assert self.indices.ndim == 1
        assert int(self.indptr[-1]) == self.indices.shape[0]

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    def out_degree(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int64)

    def in_degree(self) -> np.ndarray:
        return np.bincount(self.indices, minlength=self.num_nodes).astype(np.int64)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]

    def edges(self) -> tuple[np.ndarray, np.ndarray]:
        """Return (src, dst) arrays."""
        src = np.repeat(np.arange(self.num_nodes, dtype=np.int32), self.out_degree())
        return src, self.indices.astype(np.int32)

    def reverse(self) -> "Graph":
        src, dst = self.edges()
        return csr_from_edges(dst, src, self.num_nodes)

    def to_undirected(self) -> "Graph":
        src, dst = self.edges()
        s = np.concatenate([src, dst])
        d = np.concatenate([dst, src])
        return csr_from_edges(s, d, self.num_nodes, dedup=True)

    def has_edge_weights(self) -> bool:
        return self.edge_weight is not None


def csr_from_edges(src: np.ndarray, dst: np.ndarray, num_nodes: int,
                   weight: Optional[np.ndarray] = None,
                   dedup: bool = False) -> Graph:
    """Build a CSR graph from an edge list (duplicates optionally removed)."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    assert src.shape == dst.shape
    if dedup:
        key = src * num_nodes + dst
        _, uniq = np.unique(key, return_index=True)
        src, dst = src[uniq], dst[uniq]
        if weight is not None:
            weight = weight[uniq]
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    if weight is not None:
        weight = np.asarray(weight, dtype=np.float32)[order]
    counts = np.bincount(src, minlength=num_nodes)
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return Graph(indptr=indptr, indices=dst.astype(np.int32),
                 num_nodes=num_nodes, edge_weight=weight)


def symmetric_normalize(g: Graph, add_self_loops: bool = True) -> Graph:
    """GCN-style symmetric normalization: A_hat = D^-1/2 (A [+ I]) D^-1/2.

    Returns a new Graph whose ``edge_weight`` carries the normalized values.
    """
    src, dst = g.edges()
    if add_self_loops:
        loop = np.arange(g.num_nodes, dtype=np.int32)
        src = np.concatenate([src, loop])
        dst = np.concatenate([dst, loop])
    deg = np.bincount(src, minlength=g.num_nodes) + np.bincount(dst, minlength=g.num_nodes)
    deg = deg.astype(np.float64) / 2.0  # undirected-ish degree estimate
    # Use in/out degree product for directed graphs (standard GCN uses
    # undirected degree; for our symmetric generators these coincide).
    deg_out = np.bincount(src, minlength=g.num_nodes).astype(np.float64)
    deg_in = np.bincount(dst, minlength=g.num_nodes).astype(np.float64)
    d_out = np.where(deg_out > 0, deg_out, 1.0) ** -0.5
    d_in = np.where(deg_in > 0, deg_in, 1.0) ** -0.5
    w = (d_out[src] * d_in[dst]).astype(np.float32)
    return csr_from_edges(src, dst, g.num_nodes, weight=w)


def subgraph(g: Graph, nodes: np.ndarray) -> tuple[Graph, np.ndarray]:
    """Node-induced subgraph.

    Returns (sub, mapping) where ``mapping[local] = global`` and edges are
    kept only if both endpoints are in ``nodes``.
    """
    nodes = np.asarray(nodes, dtype=np.int64)
    lut = -np.ones(g.num_nodes, dtype=np.int64)
    lut[nodes] = np.arange(nodes.shape[0])
    src, dst = g.edges()
    keep = (lut[src] >= 0) & (lut[dst] >= 0)
    w = g.edge_weight[keep] if g.edge_weight is not None else None
    sub = csr_from_edges(lut[src[keep]], lut[dst[keep]], nodes.shape[0], weight=w)
    return sub, nodes
