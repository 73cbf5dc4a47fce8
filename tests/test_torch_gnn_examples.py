"""The GNN example twins and the serving freshness path against the JAX
package, on the CPU.

- ``examples/heterogeneous_rapa_torch.py`` at a reduced scale and epoch
  count, against the JAX example's steps at the same ones: per device
  group (x2 to x8) the heterogeneity and the uniform and RAPA max-costs
  (host numpy) exactly equal; the x8 GraphSAGE run's bytes, reduction
  and refresh count equal, and its ``spec`` dict the one the JAX
  package's loose-keyword shim builds from its defaults;
- ``examples/serve_gnn_torch.py`` at its defaults but a stream of
  :data:`SERVE_QUERIES` queries, against the JAX example's steps: the
  store's size and both streams' counts equal (they depend on ids, not
  on parameters), before and after the feature update;
- both ``launch.serve gnn`` CLIs with ``--update-frac 0.01``, traced: the
  stale count and the stream's ``queries``, ``hot_hits``, ``host_hits``,
  ``fresh_recomputes`` (summed over the per-batch counter records),
  ``batches``, ``fresh_rate`` and ``hot_hit_rate`` equal.
"""
import argparse
import importlib.util
import json
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest

import repro.core as jcore
import repro.data as jdata
import repro.dist as jdist
import repro.graph as jgraph
from repro.launch import serve as jserve
from repro.models.gnn import GNNConfig as JConfig, init_gnn as jinit
from repro.optim import adam as jadam
from repro.serve import (BatchConfig as JBatch, GNNServeEngine as JEngine,
                         precompute_embeddings as jprecompute,
                         rank_hot_nodes as jrank, serve_stream as jstream,
                         zipf_stream as jzipf)
from repro_torch.launch import serve as tserve
from torch_threads import torch_threads_per_worker  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
STREAM_COUNTS = ("queries", "batches", "mean_batch", "hot_hit_rate",
                 "host_hit_rate", "fresh_rate")
# the JAX engine compiles its recompute for each stale batch's subgraph:
# short streams keep the tests to seconds
SERVE_QUERIES = 64
CLI_QUERIES = 60


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_heterogeneous_rapa_twin_matches_the_reference(capsys):
    scale, epochs = 0.02, 4
    got = _example("heterogeneous_rapa_torch").main(device="cpu",
                                                    scale=scale,
                                                    epochs=epochs)
    assert "x8 GraphSAGE" in capsys.readouterr().out

    # the JAX example's steps at the same scale and epochs
    task = jdata.make_task("flickr", scale=scale, feat_dim=64, seed=0)
    cfg_r = jcore.RapaConfig(feat_dim=64)
    for grp in ("x2", "x4", "x6", "x8"):
        profiles = jcore.make_group(jcore.PAPER_GROUPS[grp])
        ps = jgraph.build_partition(
            task.graph, jgraph.metis_partition(task.graph, len(profiles),
                                               seed=0), hops=1)
        lam0 = jcore.partition_lambdas(ps, profiles, cfg_r)
        lam1 = jcore.do_partition(ps, profiles, cfg_r).lambda_final
        het = max(p.mm for p in profiles) / min(p.mm for p in profiles)
        assert got["groups"][grp] == {
            "het": het, "uniform_max_cost": float(lam0.max()),
            "rapa_max_cost": float(np.max(lam1))}, grp
    profiles = jcore.make_group(jcore.PAPER_GROUPS["x8"])
    ps = jgraph.build_partition(
        task.graph, jgraph.metis_partition(task.graph, 8, seed=0), hops=1)
    ps = jcore.do_partition(ps, profiles, cfg_r).partition_set
    gcfg = JConfig(model="sage", in_dim=64, hidden_dim=128,
                   out_dim=task.num_classes, num_layers=3)
    cap = jcore.cal_capacity(ps, gcfg.feat_dims, profiles)
    xplan = jdist.build_exchange_plan(
        ps, jcore.build_cache_plan(ps, cap, refresh_every=4))
    sp = jdist.stack_partitions(ps, task)
    opt = jadam(0.01)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        rt = jdist.make_sim_runtime(gcfg, sp, xplan, opt)
        _, rep = jdist.train_capgnn(
            gcfg, rt, xplan, 8, opt, epochs=epochs,
            controller=jcore.StalenessController(refresh_every=4))
    assert got["spec"] == rep.spec
    for k in ("comm_bytes", "comm_bytes_vanilla", "comm_reduction"):
        assert got[k] == getattr(rep, k), k
    assert got["step_kinds"].count("cached") == rep.cached_steps
    assert len(got["losses"]) == epochs
    assert np.all(np.isfinite(got["losses"]))
    assert 0.0 <= got["test_acc"] <= 1.0


def test_serve_gnn_twin_counts_match_the_reference(capsys):
    got = _example("serve_gnn_torch").main(device="cpu",
                                           queries=SERVE_QUERIES)
    assert "fresh_rate" in capsys.readouterr().out

    # the JAX example's steps at its defaults
    seed, parts = 0, 4
    task = jdata.make_task("flickr", scale=0.01, feat_dim=32, seed=seed)
    g = task.graph
    ps = jgraph.build_partition(g, jgraph.metis_partition(g, parts,
                                                          seed=seed), hops=1)
    cfg = JConfig(model="gcn", in_dim=32, hidden_dim=64,
                  out_dim=task.num_classes, num_layers=3)
    params = jinit(jax.random.PRNGKey(seed), cfg)
    cap = jcore.cal_capacity(ps, cfg.feat_dims,
                             [jcore.PROFILES["rtx3090"]] * parts)
    xplan = jdist.build_exchange_plan(ps, jcore.build_cache_plan(ps, cap))
    store = jprecompute(cfg, ps, jdist.stack_partitions(ps, task), xplan,
                        params)
    hot = jrank(g, g.num_nodes // 10, ps=ps, policy="degree")
    engine = JEngine(store, params, g, hot, features=task.features)
    stream = jzipf(g.num_nodes, SERVE_QUERIES, qps=500.0, alpha=1.1,
                   seed=seed,
                   rank_to_node=jrank(g, g.num_nodes, policy="degree"))
    report = jstream(engine, stream, JBatch(max_batch=64, deadline_ms=2.0))
    rng = np.random.default_rng(seed)
    upd = rng.choice(g.num_nodes, max(1, g.num_nodes // 200), replace=False)
    engine.update_features(upd, task.features[upd] + 0.5)
    fresh = jstream(engine, stream, JBatch(max_batch=64, deadline_ms=2.0))

    assert (got["tables"], got["nodes"], got["updated"], got["stale"]) == \
        (len(store.tables), store.num_nodes, upd.size,
         int(engine.stale.sum()))
    for name, want in (("report", report), ("fresh_report", fresh)):
        assert {k: got[name][k] for k in STREAM_COUNTS} == \
            {k: want[k] for k in STREAM_COUNTS}, name
    assert got["fresh_report"]["fresh_rate"] > 0 == \
        got["report"]["fresh_rate"]


def _stream_counts(metrics_file) -> dict:
    """The per-batch ``serve`` counter records summed."""
    recs = [json.loads(line) for line in Path(metrics_file).read_text()
            .splitlines()]
    recs = [r for r in recs if r.get("kind") == "serve"]
    return {k: sum(r[k] for r in recs) for k in
            ("queries", "hot_hits", "host_hits", "fresh_recomputes")}


@pytest.mark.parametrize("fresh_hops", [None, 1])
def test_serve_cli_fresh_counts_match(tmp_path, capsys, fresh_hops):
    flags = dict(scale=0.02, feat_dim=16, hidden=16, queries=CLI_QUERIES,
                 qps=2000.0, backend="hybrid", update_frac=0.01,
                 fresh_hops=fresh_hops)
    argv = ["gnn", "--device", "cpu", "--scale", "0.02", "--feat-dim", "16",
            "--hidden", "16", "--queries", str(CLI_QUERIES), "--qps", "2000",
            "--backend", "hybrid", "--update-frac", "0.01", "--trace",
            "--trace-dir", str(tmp_path / "torch")]
    if fresh_hops is not None:
        argv += ["--fresh-hops", str(fresh_hops)]
    got = tserve.main(argv)
    jargs = argparse.Namespace(
        dataset="flickr", model="gcn", layers=3, parts=4,
        partitioner="metis", refresh_every=4, cpu_cache_gib=4.0,
        ckpt_dir="", store_dir="", load_store=False, hot_frac=0.1,
        hot_rank="degree", workload="zipf", alpha=1.1, popularity="degree",
        max_batch=64, deadline_ms=2.0, trace=True,
        trace_dir=str(tmp_path / "jax"), seed=0, **flags)
    want = jserve.run_gnn(jargs)
    capsys.readouterr()
    assert got.keys() == want.keys()
    for k in ("stale_nodes", "queries", "batches", "fresh_rate",
              "hot_hit_rate", "host_hit_rate"):
        assert got[k] == want[k], k
    counts = _stream_counts(got["metrics_file"])
    assert counts == _stream_counts(want["metrics_file"])
    assert counts["fresh_recomputes"] > 0 and got["fresh_rate"] > 0
    assert counts["queries"] == got["queries"] == CLI_QUERIES
