"""Vertex reordering for memory-access locality (paper Fig. 13).

After RAPA adjustment each subgraph is reordered so that frequently
co-accessed vertices are contiguous: inner vertices by BFS (RCM-like) order,
halo vertices by descending overlap ratio (so the JACA cache prefix is a
contiguous slice of the halo block).

A numpy copy of the JAX package's ``graph/reorder.py`` (the same
permutations for the same graph).
"""
from __future__ import annotations

from collections import deque

import numpy as np

from .graph import Graph, csr_from_edges

__all__ = ["bfs_order", "reorder_partition_arrays"]


def bfs_order(g: Graph, start: int = 0) -> np.ndarray:
    """BFS (Cuthill-McKee style) permutation: order[new_id] = old_id."""
    n = g.num_nodes
    seen = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    k = 0
    deg = g.out_degree()
    for seed in np.argsort(deg):  # low-degree seeds first, RCM heuristic
        if seen[seed]:
            continue
        q = deque([int(seed)])
        seen[seed] = True
        while q:
            v = q.popleft()
            order[k] = v
            k += 1
            nbr = g.neighbors(v)
            nbr = nbr[~seen[nbr]]
            # visit neighbours in increasing degree order
            for u in nbr[np.argsort(deg[nbr])]:
                if not seen[u]:
                    seen[u] = True
                    q.append(int(u))
    assert k == n
    return order


def reorder_partition_arrays(local_graph: Graph, n_inner: int,
                             halo_priority: np.ndarray
                             ) -> tuple[Graph, np.ndarray]:
    """Reorder a partition-local graph.

    Inner ids get BFS order over the inner-inner subgraph; halo ids are
    sorted by descending ``halo_priority`` (overlap ratio).  Returns the
    permuted graph and ``perm`` with ``perm[new_local] = old_local``.
    """
    n_local = local_graph.num_nodes
    n_halo = n_local - n_inner
    # BFS over inner-induced subgraph
    src, dst = local_graph.edges()
    keep = (src < n_inner) & (dst < n_inner)
    inner_g = csr_from_edges(src[keep], dst[keep], n_inner)
    inner_perm = bfs_order(inner_g)
    halo_perm = n_inner + np.argsort(-halo_priority, kind="stable")
    perm = np.concatenate([inner_perm, halo_perm])
    inv = np.empty(n_local, dtype=np.int64)
    inv[perm] = np.arange(n_local)
    new_g = csr_from_edges(inv[src], inv[dst], n_local,
                           weight=local_graph.edge_weight)
    return new_g, perm
