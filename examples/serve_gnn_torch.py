"""Serving walkthrough of the PyTorch port: precompute -> two-tier cache
engine -> query stream, through ``repro_torch`` only.

The steps of ``examples/serve_gnn.py``: a small partitioned task,
per-layer embeddings precomputed through the CaPGNN exchange machinery,
a zipf query stream served from the two-tier cache (the hot tier through
the row-gather kernel on the card), and a feature update pushed through
the fresh=k recompute path.  The CLI equivalent is ``python -m
repro_torch.launch.serve gnn``.

    PYTHONPATH=src python examples/serve_gnn_torch.py [--device cpu]

It runs on the card unless given ``--device cpu``.
"""
import argparse
import json

import numpy as np
import torch

from repro_torch.core import PROFILES, build_cache_plan, cal_capacity
from repro_torch.data import make_task
from repro_torch.dist import build_exchange_plan, stack_partitions
from repro_torch.graph import build_partition, metis_partition
from repro_torch.launch.serve import resolve_device, set_fp32_numerics
from repro_torch.models.gnn import GNNConfig, init_gnn
from repro_torch.serve import (BatchConfig, GNNServeEngine,
                               precompute_embeddings, rank_hot_nodes,
                               serve_stream, zipf_stream)


def main(device: str = "cuda", dataset: str = "flickr", scale: float = 0.01,
         parts: int = 4, queries: int = 1024, seed: int = 0) -> dict:
    """Run the walkthrough; returns its figures (the store's size, the
    first stream's report, and the update's node and stale counts beside
    the second stream's report)."""
    device = resolve_device(device)       # raises for cuda without CUDA
    set_fp32_numerics()
    # 1. the usual CaPGNN setup: task, partitions, JACA plan, exchange plan
    task = make_task(dataset, scale=scale, feat_dim=32, seed=seed)
    g = task.graph
    ps = build_partition(g, metis_partition(g, parts, seed=seed), hops=1)
    cfg = GNNConfig(model="gcn", in_dim=32, hidden_dim=64,
                    out_dim=task.num_classes, num_layers=3)
    params = init_gnn(cfg, torch.Generator().manual_seed(seed), device)
    cap = cal_capacity(ps, cfg.feat_dims, [PROFILES["rtx3090"]] * parts)
    xplan = build_exchange_plan(ps, build_cache_plan(ps, cap))
    sp = stack_partitions(ps, task)

    # 2. offline: one partitioned layer-wise inference pass over the graph
    store = precompute_embeddings(cfg, ps, sp, xplan, params, device=device)
    print(f"precomputed {len(store.tables)} layer tables over "
          f"{store.num_nodes} nodes")

    # 3. online: degree-ranked hot tier + micro-batched query engine
    hot = rank_hot_nodes(g, g.num_nodes // 10, ps=ps, policy="degree")
    engine = GNNServeEngine(store, params, g, hot, features=task.features,
                            device=device)
    by_degree = rank_hot_nodes(g, g.num_nodes, policy="degree")
    stream = zipf_stream(g.num_nodes, queries, qps=500.0, alpha=1.1,
                         seed=seed, rank_to_node=by_degree)
    report = serve_stream(engine, stream,
                          BatchConfig(max_batch=64, deadline_ms=2.0))
    print(json.dumps({k: round(v, 4) if isinstance(v, float) else v
                      for k, v in report.items()}, indent=1))

    # 4. freshness: update some features, serve again — stale nodes take
    #    the k-hop recompute path, clean ones still hit the cache tiers
    rng = np.random.default_rng(seed)
    upd = rng.choice(g.num_nodes, max(1, g.num_nodes // 200), replace=False)
    engine.update_features(upd, task.features[upd] + 0.5)
    fresh = serve_stream(engine, stream,
                         BatchConfig(max_batch=64, deadline_ms=2.0))
    stale = int(engine.stale.sum())
    print(f"after updating {upd.size} nodes ({stale} stale):"
          f" fresh_rate {fresh['fresh_rate']:.2%}, "
          f"hot {fresh['hot_hit_rate']:.2%}, qps {fresh['qps']:.0f}")
    return {"tables": len(store.tables), "nodes": store.num_nodes,
            "report": report, "updated": int(upd.size), "stale": stale,
            "fresh_report": fresh}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--dataset", default="flickr")
    ap.add_argument("--scale", type=float, default=0.01)
    ap.add_argument("--parts", type=int, default=4)
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    main(**vars(ap.parse_args()))
