"""The port's numpy substrate equals the JAX package's, array for array.

``make_task`` -> partitioners -> ``build_partition`` -> ``cal_capacity``
-> ``build_cache_plan`` -> ``build_exchange_plan`` -> ``stack_partitions``
(edges, ell, hybrid), the ELL packs, and the serving workload streams: the
same seed must give byte-identical arrays (same dtype, same shape, same
values) in ``repro_torch`` and in ``repro``.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as jcore
import repro.data as jdata
import repro.dist as jdist
import repro.graph as jgraph
import repro.kernels.ops as jops
import repro.serve as jserve
import repro_torch.core as tcore
import repro_torch.data as tdata
import repro_torch.dist as tdist
import repro_torch.graph as tgraph
import repro_torch.kernels.ops as tops
import repro_torch.serve as tserve
from torch_threads import torch_threads_per_worker  # noqa: F401

SCALE, FEAT, PARTS, SEED = 0.02, 32, 4, 0
FEAT_DIMS = [FEAT, 32, 32, 7]
_CACHE: dict = {}


def assert_identical(a, b, path="value"):
    """Recursive exact equality over dataclasses, arrays and containers."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            assert_identical(getattr(a, f.name), getattr(b, f.name),
                             f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
        assert a.shape == b.shape, (path, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_identical(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_identical(a[k], b[k], f"{path}[{k!r}]")
    else:
        assert a == b, (path, a, b)


def _pipeline(pkg):
    """``(task, ps, cap, plan, xplan)`` through one package."""
    core, data, dist, graph = pkg
    key = id(core)
    if key not in _CACHE:
        task = data.make_task("flickr", scale=SCALE, feat_dim=FEAT,
                              seed=SEED)
        g = task.graph
        ps = graph.build_partition(
            g, graph.metis_partition(g, PARTS, seed=SEED), hops=1)
        profiles = core.make_group(core.PAPER_GROUPS[f"x{PARTS}"])
        cap = core.cal_capacity(ps, FEAT_DIMS, profiles, m_cpu_gib=4.0)
        plan = core.build_cache_plan(ps, cap, refresh_every=4)
        xplan = dist.build_exchange_plan(ps, plan)
        _CACHE[key] = (task, ps, cap, plan, xplan)
    return _CACHE[key]


JAX_PKG = (jcore, jdata, jdist, jgraph)
TORCH_PKG = (tcore, tdata, tdist, tgraph)


def test_make_task_identical():
    assert_identical(_pipeline(TORCH_PKG)[0], _pipeline(JAX_PKG)[0], "task")


@pytest.mark.parametrize("name", ["flickr", "coauthor-physics", "corafull"])
def test_make_dataset_identical(name):
    """rmat and sbm generators alike."""
    got = tgraph.make_dataset(name, scale=0.01, seed=3)
    want = jgraph.make_dataset(name, scale=0.01, seed=3)
    assert_identical(got, want, name)


@pytest.mark.parametrize("partitioner", ["metis_partition",
                                         "random_partition",
                                         "fennel_partition"])
@pytest.mark.parametrize("weights", [None, [0.4, 0.3, 0.2, 0.1]])
def test_partitioners_identical(partitioner, weights):
    g = _pipeline(JAX_PKG)[0].graph
    got = getattr(tgraph, partitioner)(g, PARTS, seed=1, weights=weights)
    want = getattr(jgraph, partitioner)(g, PARTS, seed=1, weights=weights)
    assert_identical(got, want, partitioner)


@pytest.mark.parametrize("hops", [1, 2])
def test_build_partition_identical(hops):
    g = _pipeline(JAX_PKG)[0].graph
    assign = jgraph.metis_partition(g, PARTS, seed=SEED)
    assert_identical(tgraph.build_partition(g, assign, hops=hops),
                     jgraph.build_partition(g, assign, hops=hops), "ps")


def test_capacity_and_cache_plan_identical():
    _, _, cap_t, plan_t, _ = _pipeline(TORCH_PKG)
    _, _, cap_j, plan_j, _ = _pipeline(JAX_PKG)
    assert_identical(cap_t, cap_j, "capacity")
    assert_identical(plan_t, plan_j, "plan")


@pytest.mark.parametrize("policy", ["overlap_low", "random"])
def test_ablation_cache_plans_identical(policy):
    _, ps, cap, _, _ = _pipeline(JAX_PKG)
    assert_identical(tcore.build_cache_plan(ps, cap, policy=policy, seed=2),
                     jcore.build_cache_plan(ps, cap, policy=policy, seed=2),
                     policy)


def test_exchange_plan_identical():
    assert_identical(_pipeline(TORCH_PKG)[4], _pipeline(JAX_PKG)[4], "xplan")


def test_slot_stable_exchange_plan_identical():
    _, ps, cap, plan, _ = _pipeline(JAX_PKG)
    pad_t = tdist.exchange_capacity(ps, cap)
    pad_j = jdist.exchange_capacity(ps, cap)
    assert_identical(pad_t, pad_j, "capacity_pad")
    assert_identical(tdist.build_exchange_plan(ps, plan, pad_to=pad_t),
                     jdist.build_exchange_plan(ps, plan, pad_to=pad_j),
                     "xplan_padded")


@pytest.mark.parametrize("backend", ["edges", "ell", "hybrid"])
def test_stack_partitions_identical(backend):
    task, ps = _pipeline(JAX_PKG)[:2]
    assert_identical(tdist.stack_partitions(ps, task, backend=backend),
                     jdist.stack_partitions(ps, task, backend=backend),
                     backend)


@pytest.mark.parametrize("max_deg", [None, 3])
def test_ell_pack_identical(max_deg):
    rng = np.random.default_rng(5)
    src = rng.integers(0, 90, 700).astype(np.int32)
    dst = rng.integers(0, 60, 700).astype(np.int32)
    w = rng.normal(size=700).astype(np.float32)
    assert_identical(tops.ell_pack(src, dst, w, 60, max_deg=max_deg),
                     jops.ell_pack(src, dst, w, 60, max_deg=max_deg), "ell")


@pytest.mark.parametrize("quantile", [0.5, 0.95])
def test_ell_pack_hybrid_identical(quantile):
    rng = np.random.default_rng(6)
    src = rng.integers(0, 90, 700).astype(np.int32)
    dst = (rng.zipf(1.6, 700) % 60).astype(np.int32)
    w = rng.normal(size=700).astype(np.float32)
    assert_identical(
        tops.ell_pack_hybrid(src, dst, w, 60, quantile=quantile),
        jops.ell_pack_hybrid(src, dst, w, 60, quantile=quantile), "hybrid")


@pytest.mark.parametrize("kind", ["uniform", "zipf", "bursty"])
def test_workload_streams_identical(kind):
    order = np.random.default_rng(1).permutation(500)
    for rank_to_node in (None, order):
        got = tserve.make_stream(kind, 500, 300, qps=800.0, alpha=1.2,
                                 seed=7, rank_to_node=rank_to_node)
        want = jserve.make_stream(kind, 500, 300, qps=800.0, alpha=1.2,
                                  seed=7, rank_to_node=rank_to_node)
        assert_identical(got, want, kind)


@pytest.mark.parametrize("max_batch,deadline_ms", [(1, 2.0), (8, 0.5),
                                                   (64, 2.0)])
def test_plan_batches_identical(max_batch, deadline_ms):
    times = np.cumsum(np.random.default_rng(3).exponential(0.001, 400))
    got = tserve.plan_batches(times, tserve.BatchConfig(max_batch,
                                                        deadline_ms))
    want = jserve.plan_batches(times, jserve.BatchConfig(max_batch,
                                                         deadline_ms))
    assert_identical(got, want, "batches")


@pytest.mark.parametrize("policy", ["degree", "overlap"])
def test_rank_hot_nodes_identical(policy):
    task, ps = _pipeline(JAX_PKG)[:2]
    assert_identical(
        tserve.rank_hot_nodes(task.graph, 100, ps=ps, policy=policy),
        jserve.rank_hot_nodes(task.graph, 100, ps=ps, policy=policy), policy)
