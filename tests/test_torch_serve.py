"""The port's serving slice against the JAX package's, on the CPU.

Parameters come from the JAX package's ``init_gnn`` and are carried across
with ``params_from_reference``.  Held:

- every precompute table within 1e-5, for the edges, ell and hybrid
  backends (ell/hybrid: the Pallas kernels in interpret mode on the JAX
  side, the plain versions on the port's);
- engine lookups on hot hits and host misses, and the fresh-recompute path
  after ``update_features``, within 1e-5, with equal counters;
- ``serve_stream``'s count and hit-rate fields exactly equal.
"""
import argparse
import json

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.data as jdata
import repro.dist as jdist
import repro.graph as jgraph
import repro.serve as jserve
from repro.dist.host_store import HostFeatureStore as JHostStore
from repro.launch import serve as jlaunch
from repro.models.gnn import GNNConfig as JConfig, init_gnn as jinit
from repro_torch.convert import params_from_reference
from repro_torch.dist import stack_partitions
from repro_torch.dist.host_store import HostFeatureStore, halo_dtype_info
from repro_torch.launch import serve as tlaunch
from repro_torch.models.gnn import GNNConfig
from repro_torch.serve import (BatchConfig, GNNServeEngine, make_stream,
                               precompute_embeddings, rank_hot_nodes,
                               serve_stream)
from torch_threads import torch_threads_per_worker  # noqa: F401

BACKENDS = ("edges", "ell", "hybrid")
TOL = dict(rtol=1e-5, atol=1e-5)
CPU = "cpu"
_CACHE: dict = {}


def _base():
    """flickr at scale 0.02, 32 input features, GCN 32-32-7, 4 parts."""
    if "base" not in _CACHE:
        task = jdata.make_task("flickr", scale=0.02, feat_dim=32, seed=0)
        g = task.graph
        ps = jgraph.build_partition(
            g, jgraph.metis_partition(g, 4, seed=0), hops=1)
        kw = dict(model="gcn", in_dim=32, hidden_dim=32,
                  out_dim=task.num_classes, num_layers=3)
        jcfg, tcfg = JConfig(**kw), GNNConfig(**kw)
        jparams = jinit(jax.random.PRNGKey(0), jcfg)
        tparams = params_from_reference(
            [{k: np.asarray(v) for k, v in layer.items()}
             for layer in jparams], device=CPU)
        cap = jcore.cal_capacity(
            ps, jcfg.feat_dims,
            jcore.make_group(jcore.PAPER_GROUPS["x4"]), m_cpu_gib=4.0)
        xplan = jdist.build_exchange_plan(
            ps, jcore.build_cache_plan(ps, cap, refresh_every=4))
        _CACHE["base"] = (task, ps, jcfg, tcfg, jparams, tparams, xplan)
    return _CACHE["base"]


def _stores(backend):
    """(JAX store, port store) of one backend's precompute pass."""
    if backend not in _CACHE:
        task, ps, jcfg, tcfg, jparams, tparams, xplan = _base()
        jstore = jserve.precompute_embeddings(
            jcfg, ps, jdist.stack_partitions(ps, task, backend=backend),
            xplan, jparams, backend=backend, interpret=True)
        tstore = precompute_embeddings(
            tcfg, ps, stack_partitions(ps, task, backend=backend), xplan,
            tparams, backend=backend, device=CPU)
        _CACHE[backend] = (jstore, tstore)
    return _CACHE[backend]


def _engines(backend, hot=60):
    task, ps, _, _, jparams, tparams, _ = _base()
    jstore, tstore = _stores(backend)
    g = task.graph
    hot_ids = jserve.rank_hot_nodes(g, hot, ps=ps, policy="degree")
    je = jserve.GNNServeEngine(jstore, jparams, g, hot_ids,
                               features=task.features)
    te = GNNServeEngine(tstore, tparams, g, hot_ids, features=task.features,
                        device=CPU)
    return je, te


@pytest.mark.parametrize("backend", BACKENDS)
def test_precompute_tables_match_reference(backend):
    jstore, tstore = _stores(backend)
    assert tstore.dims == jstore.dims == [32, 32, 32, 7]
    assert tstore.backend == backend
    for layer, (got, want) in enumerate(zip(tstore.tables, jstore.tables)):
        assert got.dtype == np.float32 and got.shape == want.shape, layer
        np.testing.assert_allclose(got, want, err_msg=f"table {layer}",
                                   **TOL)


def test_precompute_is_backend_invariant():
    logits = [_stores(b)[1].logits for b in BACKENDS]
    for other in logits[1:]:
        np.testing.assert_allclose(other, logits[0], **TOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_engine_lookup_parity_hot_and_host(backend):
    je, te = _engines(backend)
    q = np.arange(0, te.graph.num_nodes, 3)
    got, want = te.lookup(q), je.lookup(q)
    assert te.stats["hot_hits"] > 0, "hot tier never hit"
    assert te.stats["host_hits"] > 0, "host tier never hit"
    np.testing.assert_allclose(got, want, **TOL)
    for k in ("queries", "hot_hits", "host_hits", "batches"):
        assert te.stats[k] == je.stats[k], k
    for k in ("fetches", "fetch_rows", "fetch_bytes"):
        assert te.host_store.stats[k] == je.host_store.stats[k], k


def test_fresh_recompute_parity():
    je, te = _engines("hybrid")
    task = _base()[0]
    upd = np.array([5, 77, 400])
    newf = task.features[upd] + 1.5
    je.update_features(upd, newf)
    te.update_features(upd, newf)
    np.testing.assert_array_equal(te.stale, je.stale)
    q = np.arange(0, te.graph.num_nodes, 3)
    got, want = te.query(q), je.query(q)
    assert te.stats["fresh_recomputes"] > 0
    np.testing.assert_allclose(got, want, **TOL)
    for k in ("queries", "hot_hits", "host_hits", "fresh_recomputes",
              "batches"):
        assert te.stats[k] == je.stats[k], k


EXACT_FIELDS = ("queries", "batches", "mean_batch", "hot_hit_rate",
                "host_hit_rate", "fresh_rate")


@pytest.mark.parametrize("kind,update", [("zipf", False), ("bursty", True),
                                         ("uniform", False)])
def test_serve_stream_counts_equal(kind, update):
    je, te = _engines("edges")
    g = te.graph
    if update:
        upd = np.array([3, 150])
        newf = _base()[0].features[upd] - 1.0
        je.update_features(upd, newf)
        te.update_features(upd, newf)
    order = rank_hot_nodes(g, g.num_nodes, policy="degree")
    stream = make_stream(kind, g.num_nodes, 400, qps=2000.0, alpha=1.1,
                         seed=1, rank_to_node=order)
    bcfg = dict(max_batch=32, deadline_ms=2.0)
    got = serve_stream(te, stream, BatchConfig(**bcfg))
    want = jserve.serve_stream(je, stream, jserve.BatchConfig(**bcfg))
    assert got.keys() == want.keys()
    for k in EXACT_FIELDS:
        assert got[k] == want[k], k
    assert got["fresh_rate"] > 0 if update else got["fresh_rate"] == 0


@pytest.mark.parametrize("halo_dtype", [None, "bf16"])
def test_host_store_staging_accounting(halo_dtype):
    rng = np.random.default_rng(2)
    feat = rng.normal(size=(3, 20, 6)).astype(np.float32)
    idx = (np.arange(3)[:, None], rng.integers(0, 20, (3, 8)))
    valid = rng.random((3, 8)) < 0.7
    ts = HostFeatureStore(feat, halo_dtype=halo_dtype, device=CPU)
    js = JHostStore(feat, halo_dtype=halo_dtype)
    got, want = ts.stage_rows(idx, valid), js.stage_rows(idx, valid)
    assert (got.rows, got.nbytes) == (want.rows, want.nbytes)
    np.testing.assert_array_equal(got.array.float().numpy(),
                                  np.asarray(want.array, np.float32))
    ts.account_fetch(got)
    js.account_fetch(want)
    for k in ("fetches", "fetch_rows", "fetch_bytes"):
        assert ts.stats[k] == js.stats[k], k
    before = ts.snapshot()
    np.testing.assert_array_equal(ts.fetch_rows(np.array([1, 2])),
                                  js.fetch_rows(np.array([1, 2])))
    assert ts.delta(before)["fetch_rows"] == 2 * 20


def test_halo_dtype_info():
    assert halo_dtype_info(None) == (None, 4)
    assert halo_dtype_info("f32") == (None, 4)
    assert halo_dtype_info("bf16") == (torch.bfloat16, 2)
    with pytest.raises(ValueError, match="halo_dtype"):
        halo_dtype_info("fp8")


def test_cli_report_matches_reference_counts(capsys):
    """The port's CLI prints the JAX CLI's fields; with the same seed the
    stream, batches and hit rates are equal (the parameters differ, since
    ``jax.random`` cannot be replayed, and the logits with them)."""
    got = tlaunch.main(["gnn", "--device", "cpu", "--scale", "0.02",
                        "--feat-dim", "16", "--hidden", "16",
                        "--queries", "300", "--qps", "2000",
                        "--backend", "hybrid"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == got
    jargs = argparse.Namespace(
        dataset="flickr", scale=0.02, feat_dim=16, model="gcn",
        backend="hybrid", hidden=16, layers=3, parts=4,
        partitioner="metis", refresh_every=4, cpu_cache_gib=4.0,
        ckpt_dir="", store_dir="", load_store=False, hot_frac=0.1,
        hot_rank="degree", workload="zipf", queries=300, qps=2000.0,
        alpha=1.1, popularity="degree", max_batch=64, deadline_ms=2.0,
        update_frac=0.0, fresh_hops=None, trace=False,
        trace_dir="experiments", seed=0)
    want = jlaunch.run_gnn(jargs)
    capsys.readouterr()
    assert got.keys() == want.keys()
    for k in ("dataset", "model", "backend", "parts", "nodes", "layers",
              "hot_capacity", "hot_rank", "stale_nodes", "workload",
              *EXACT_FIELDS):
        assert got[k] == want[k], k
