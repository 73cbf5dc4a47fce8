"""Synthetic graph dataset generators.

The container is offline so the paper's DGL/OGB datasets (CoraFull, Flickr,
Reddit, Yelp, AmazonProducts, ogbn-products, ...) are reproduced *in shape*:
we generate graphs whose degree distribution, clustering and scale knobs
mirror each dataset's published statistics (Table 5 of the paper), at a
configurable scale factor so tests stay fast and benchmarks stay faithful in
structure (power-law skew is what drives halo behaviour).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from .graph import Graph, csr_from_edges

__all__ = ["DatasetSpec", "PAPER_DATASETS", "rmat", "sbm", "erdos_renyi",
           "make_dataset", "synth_features"]


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """Shape statistics of a node-classification dataset (paper Table 5)."""
    name: str
    num_nodes: int
    num_edges: int
    feat_dim: int
    num_classes: int
    multilabel: bool = False
    generator: str = "rmat"   # rmat | sbm


# Paper Table 5 (full-scale stats; benchmarks use scale=... to shrink).
PAPER_DATASETS: dict[str, DatasetSpec] = {
    "corafull": DatasetSpec("corafull", 19_793, 126_842, 8_710, 70),
    "flickr": DatasetSpec("flickr", 89_250, 899_756, 500, 7),
    "coauthor-physics": DatasetSpec("coauthor-physics", 34_493, 495_924, 8_415, 5, generator="sbm"),
    "reddit": DatasetSpec("reddit", 232_965, 114_615_892, 602, 41),
    "yelp": DatasetSpec("yelp", 716_847, 13_954_819, 300, 100, multilabel=True),
    "amazon-products": DatasetSpec("amazon-products", 1_569_960, 264_339_468, 200, 107, multilabel=True),
    "ogbn-products": DatasetSpec("ogbn-products", 2_449_029, 61_859_140, 100, 47),
}


def rmat(num_nodes: int, num_edges: int, seed: int = 0,
         a: float = 0.57, b: float = 0.19, c: float = 0.19) -> Graph:
    """R-MAT power-law generator (Graph500 parameters by default)."""
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(num_nodes, 2))))
    n = 1 << scale
    # Draw quadrant choices for every bit level at once.
    probs = np.array([a, b, c, 1.0 - a - b - c])
    src = np.zeros(num_edges, dtype=np.int64)
    dst = np.zeros(num_edges, dtype=np.int64)
    for level in range(scale):
        q = rng.choice(4, size=num_edges, p=probs)
        src |= ((q >> 1) & 1) << level
        dst |= (q & 1) << level
    # Permute ids to decorrelate bit structure, fold into [0, num_nodes).
    perm = rng.permutation(n)
    src, dst = perm[src] % num_nodes, perm[dst] % num_nodes
    keep = src != dst
    g = csr_from_edges(src[keep], dst[keep], num_nodes, dedup=True)
    return g.to_undirected()


def sbm(num_nodes: int, num_blocks: int, p_in: float, p_out: float,
        seed: int = 0) -> Graph:
    """Stochastic block model (clustered graphs, e.g. coauthor networks)."""
    rng = np.random.default_rng(seed)
    block = rng.integers(0, num_blocks, size=num_nodes)
    # Sample edges block-pair-wise to keep memory bounded.
    srcs, dsts = [], []
    idx_by_block = [np.where(block == b)[0] for b in range(num_blocks)]
    for bi in range(num_blocks):
        for bj in range(bi, num_blocks):
            p = p_in if bi == bj else p_out
            ni, nj = len(idx_by_block[bi]), len(idx_by_block[bj])
            if ni == 0 or nj == 0:
                continue
            m = rng.binomial(ni * nj, p)
            if m == 0:
                continue
            srcs.append(idx_by_block[bi][rng.integers(0, ni, m)])
            dsts.append(idx_by_block[bj][rng.integers(0, nj, m)])
    src = np.concatenate(srcs) if srcs else np.zeros(0, np.int64)
    dst = np.concatenate(dsts) if dsts else np.zeros(0, np.int64)
    keep = src != dst
    g = csr_from_edges(src[keep], dst[keep], num_nodes, dedup=True)
    return g.to_undirected()


def erdos_renyi(num_nodes: int, num_edges: int, seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_nodes, num_edges)
    dst = rng.integers(0, num_nodes, num_edges)
    keep = src != dst
    return csr_from_edges(src[keep], dst[keep], num_nodes, dedup=True).to_undirected()


def make_dataset(name: str, scale: float = 1.0, seed: int = 0
                 ) -> tuple[Graph, DatasetSpec]:
    """Generate a (possibly down-scaled) synthetic replica of a paper dataset."""
    spec = PAPER_DATASETS[name]
    n = max(64, int(spec.num_nodes * scale))
    m = max(4 * n, int(spec.num_edges * scale))
    if spec.generator == "sbm":
        g = sbm(n, num_blocks=max(4, spec.num_classes), p_in=min(0.5, 4 * m / max(1, n * n)),
                p_out=min(0.1, 0.2 * m / max(1, n * n)), seed=seed)
    else:
        g = rmat(n, m, seed=seed)
    eff = DatasetSpec(spec.name, g.num_nodes, g.num_edges, spec.feat_dim,
                      spec.num_classes, spec.multilabel, spec.generator)
    return g, eff


def synth_features(g: Graph, feat_dim: int, num_classes: int, seed: int = 0,
                   class_sep: float = 1.0
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Class-conditioned gaussian features with graph-smoothed labels.

    Labels are made graph-correlated (homophily) by label-propagating random
    seeds so GNNs genuinely beat MLPs on the synthetic task — needed for the
    accuracy-preservation experiments to be meaningful.
    """
    rng = np.random.default_rng(seed)
    n = g.num_nodes
    labels = rng.integers(0, num_classes, size=n)
    # 3 rounds of majority-ish propagation for homophily.
    src, dst = g.edges()
    for _ in range(3):
        # each node adopts label of a random in-neighbour with prob 0.7
        perm = rng.permutation(len(src))
        lab_new = labels.copy()
        lab_new[dst[perm]] = labels[src[perm]]
        take = rng.random(n) < 0.7
        labels = np.where(take, lab_new, labels)
    centers = rng.normal(0, class_sep, size=(num_classes, feat_dim))
    feats = centers[labels] + rng.normal(0, 1.0, size=(n, feat_dim))
    return feats.astype(np.float32), labels.astype(np.int32)
