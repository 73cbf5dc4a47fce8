"""Halo-vertex analytics (paper §3.4 Observations 1-2, Eq. 2).

A numpy copy of the JAX package's ``core/halo.py`` over the port's own
:class:`~repro_torch.graph.partition.PartitionSet`: the same partition
gives equal statistics (held by ``tests/test_torch_collectives.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..graph.partition import PartitionSet, edge_cut

__all__ = ["HaloStats", "halo_stats", "overlap_histogram", "duplicate_count"]


@dataclasses.dataclass(frozen=True)
class HaloStats:
    total_inner: int
    total_halo: int            # sum over partitions (with duplicates)
    unique_halo: int           # |union of halo sets|
    duplicates: int            # total_halo - unique_halo (Obs. 2 redundancy)
    halo_inner_ratio: float    # Obs. 1 metric
    overlap_mean: float
    overlap_max: int
    edge_cut: int

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def halo_stats(ps: PartitionSet) -> HaloStats:
    r = ps.overlap_ratio()
    halo_union = ps.halo_union()
    total_halo = ps.total_halo()
    uniq = int(halo_union.shape[0])
    overlaps = r[halo_union] if uniq else np.zeros(0)
    return HaloStats(
        total_inner=ps.total_inner(),
        total_halo=total_halo,
        unique_halo=uniq,
        duplicates=total_halo - uniq,
        halo_inner_ratio=total_halo / max(1, ps.total_inner()),
        overlap_mean=float(overlaps.mean()) if uniq else 0.0,
        overlap_max=int(overlaps.max()) if uniq else 0,
        edge_cut=edge_cut(ps.graph, ps.assign),
    )


def overlap_histogram(ps: PartitionSet) -> np.ndarray:
    """hist[k] = #vertices appearing in exactly k partitions' halo sets."""
    r = ps.overlap_ratio()
    return np.bincount(r[r > 0], minlength=ps.num_parts + 1)


def duplicate_count(ps: PartitionSet) -> int:
    """Number of redundant halo replicas = sum_v max(0, R(v)-1)."""
    r = ps.overlap_ratio()
    return int(np.sum(np.maximum(r - 1, 0)))
