"""Graph substrate: CSR graphs, synthetic dataset generators, partitioners
(numpy; byte-identical to the JAX package's ``repro.graph`` for a seed)."""
from .graph import Graph, csr_from_edges, symmetric_normalize, subgraph
from .generate import (DatasetSpec, PAPER_DATASETS, rmat, sbm, erdos_renyi,
                       make_dataset, synth_features)
from .partition import (Partition, PartitionSet, random_partition,
                        fennel_partition, metis_partition, build_partition,
                        edge_cut)
from .reorder import bfs_order, reorder_partition_arrays

__all__ = [
    "Graph", "csr_from_edges", "symmetric_normalize", "subgraph",
    "DatasetSpec", "PAPER_DATASETS", "rmat", "sbm", "erdos_renyi",
    "make_dataset", "synth_features",
    "Partition", "PartitionSet", "random_partition", "fennel_partition",
    "metis_partition", "build_partition", "edge_cut",
    "bfs_order", "reorder_partition_arrays",
]
