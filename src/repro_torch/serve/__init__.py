"""GNN inference serving of the port.

- :mod:`.precompute` — partitioned layer-wise full-graph inference through
  the exchange machinery; per-layer global embedding tables.
- :mod:`.engine` — two-tier (device hot / host) embedding cache with a
  static ranking, a deadline/size micro-batcher, the row-gather kernel on
  the hot path, and a k-hop fresh-recompute mode for updated features.
- :mod:`.workload` — deterministic uniform / zipf / bursty query streams.
"""
from .precompute import (EmbeddingStore, load_store, precompute_embeddings,
                         save_store)
from .engine import (Batch, BatchConfig, GNNServeEngine, MicroBatcher,
                     plan_batches, rank_hot_nodes, serve_stream)
from .workload import (QueryStream, bursty_stream, make_stream,
                       uniform_stream, zipf_stream, WORKLOAD_KINDS)

__all__ = [
    "EmbeddingStore", "precompute_embeddings", "save_store", "load_store",
    "Batch", "BatchConfig", "MicroBatcher", "plan_batches",
    "GNNServeEngine", "rank_hot_nodes", "serve_stream",
    "QueryStream", "uniform_stream", "zipf_stream", "bursty_stream",
    "make_stream", "WORKLOAD_KINDS",
]
