"""Full-batch GNN task assembly: features, labels, train/val/test masks,
and the per-partition slices the distributed runtime feeds to each worker.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..graph import (Graph, make_dataset, symmetric_normalize,
                     synth_features)
from ..graph.partition import PartitionSet

__all__ = ["FullBatchTask", "make_task", "split_masks", "partition_task"]


@dataclasses.dataclass
class FullBatchTask:
    graph: Graph                 # symmetric-normalized (edge weights set)
    features: np.ndarray         # [n, f]
    labels: np.ndarray           # [n]
    train_mask: np.ndarray       # [n] bool
    val_mask: np.ndarray
    test_mask: np.ndarray
    num_classes: int
    name: str = "synthetic"


def split_masks(n: int, seed: int = 0, train: float = 0.6, val: float = 0.2
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_tr, n_va = int(n * train), int(n * val)
    m = np.zeros(n, dtype=bool)
    tr, va, te = m.copy(), m.copy(), m.copy()
    tr[perm[:n_tr]] = True
    va[perm[n_tr:n_tr + n_va]] = True
    te[perm[n_tr + n_va:]] = True
    return tr, va, te


def make_task(name: str = "flickr", scale: float = 0.02, feat_dim: int | None = None,
              seed: int = 0) -> FullBatchTask:
    g, spec = make_dataset(name, scale=scale, seed=seed)
    fd = feat_dim if feat_dim is not None else min(spec.feat_dim, 128)
    feats, labels = synth_features(g, fd, spec.num_classes, seed=seed)
    gn = symmetric_normalize(g)
    tr, va, te = split_masks(g.num_nodes, seed=seed)
    return FullBatchTask(graph=gn, features=feats, labels=labels,
                         train_mask=tr, val_mask=va, test_mask=te,
                         num_classes=spec.num_classes, name=name)


@dataclasses.dataclass
class WorkerData:
    """Per-worker slice of a FullBatchTask."""
    feats_inner: np.ndarray      # [n_inner, f]
    feats_halo: np.ndarray       # [n_halo, f]
    labels: np.ndarray           # [n_inner]
    train_mask: np.ndarray       # [n_inner]
    val_mask: np.ndarray
    test_mask: np.ndarray


def partition_task(task: FullBatchTask, ps: PartitionSet) -> list[WorkerData]:
    out = []
    for part in ps.parts:
        out.append(WorkerData(
            feats_inner=task.features[part.inner_nodes],
            feats_halo=task.features[part.halo_nodes],
            labels=task.labels[part.inner_nodes],
            train_mask=task.train_mask[part.inner_nodes],
            val_mask=task.val_mask[part.inner_nodes],
            test_mask=task.test_mask[part.inner_nodes],
        ))
    return out
