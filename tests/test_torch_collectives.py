"""The pieces of the port's SPMD slice around the runtime, on the CPU.

- ``dist.collectives``: each autograd Function (all-gather, ring
  rotation, ring broadcast), forward and backward, on 4 gloo ranks and on
  a subgroup of 2, against the dense autograd of the stacked equivalent in
  this process (exact: the Functions only move and sum values), and the
  rows each records;
- ``kernels.ops.coo_spmm`` (the ``edges`` backend): its forward bit-equal
  to the two-index route it replaced and its gradients in ``h`` and ``w``
  within 1e-6 of the JAX package's ``EdgeListAdj.spmm`` VJP and of that
  route (``index_add_`` sums in another order than the sort-based
  backward), with padding edges;
- ``core.halo``: ``halo_stats``, ``overlap_histogram`` and
  ``duplicate_count`` exactly the JAX package's on the same partition;
- ``examples/quickstart_torch.py`` on the CPU: its halo statistics, comm
  bytes, vanilla bytes and step counts equal the figures of the JAX
  quickstart's plan at the same scale.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.data as jdata
import repro.dist as jdist
import repro.graph as jgraph
from repro.models.gnn import EdgeListAdj as JEdgeListAdj
import repro_torch.core as tcore
import repro_torch.graph as tgraph
from repro_torch.kernels import ops
from repro_torch.launch.mesh import spawn

import torch_spmd_ranks
from torch_threads import torch_threads_per_worker  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FNS = ("all_gather", "rotate", "ring_broadcast")
SIZES = {"all": 4, "pair": 2}
N, D, VALID, SHIFT = 3, 5, 2, 1
_CACHE: dict = {}


def _out_shape(fn, size):
    return {"all_gather": (size * N, D), "rotate": (N, D),
            "ring_broadcast": (size, N, D)}[fn]


def _collectives():
    if "coll" not in _CACHE:
        rng = np.random.default_rng(0)
        xs = {}
        for fn in FNS:
            xs[fn] = {"x": rng.normal(size=(4, N, D)).astype(np.float32)}
            for size in SIZES.values():
                xs[fn][f"g{size}"] = rng.normal(
                    size=(4,) + _out_shape(fn, size)).astype(np.float32)
        ranks = spawn(torch_spmd_ranks.run_collectives, 4, backend="gloo",
                      devices="cpu", args=(xs, SHIFT, VALID))
        _CACHE["coll"] = (xs, ranks)
    return _CACHE["coll"]


def _dense(fn, x, size):
    """Every rank's output of ``fn`` from the stacked inputs ``x``."""
    if fn == "all_gather":
        return [x.reshape(size * N, D)] * size
    if fn == "rotate":
        return [x[(r - SHIFT) % size] for r in range(size)]
    return [x] * size


@pytest.mark.parametrize("group", list(SIZES))
@pytest.mark.parametrize("fn", FNS)
def test_collective_matches_dense_autograd(fn, group):
    xs, ranks = _collectives()
    size = SIZES[group]
    x = torch.from_numpy(xs[fn]["x"][:size].copy()).requires_grad_(True)
    outs = _dense(fn, x, size)
    gs = [torch.from_numpy(xs[fn][f"g{size}"][r]) for r in range(size)]
    (dx,) = torch.autograd.grad(sum((o * g).sum() for o, g in zip(outs, gs)),
                                x)
    for r in range(size):
        got = ranks[r][group][fn]
        np.testing.assert_array_equal(got["y"], outs[r].detach().numpy())
        np.testing.assert_allclose(got["dx"], dx[r].numpy(), rtol=0,
                                   atol=1e-6)
    assert all(group not in res for res in ranks[size:])


@pytest.mark.parametrize("group", list(SIZES))
def test_collectives_count_their_rows(group):
    """Per rank: the all-gather's rows land on every rank, a rotation
    carries one block, the ring broadcast counts its valid rows where they
    originate and its padded rows at each of its ``size - 1`` rotations."""
    _, ranks = _collectives()
    size = SIZES[group]
    for r in range(size):
        c = ranks[r][group]["counts"][(1, "t")]
        assert c["valid_rows"] == VALID * size + VALID + VALID
        assert c["padded_rows"] == N * size + N + N * (size - 1)
        assert c["bytes"] == c["valid_rows"] * D * 4
        assert c["wire_bytes"] == c["padded_rows"] * D * 4


# ---------------------------------------------------------------------------
# ops.coo_spmm
# ---------------------------------------------------------------------------

def _coo(seed, n_rows=30, n_cols=45, m=200, d=6, pad=20):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_cols, m + pad).astype(np.int64)
    dst = rng.integers(0, n_rows, m + pad).astype(np.int64)
    dst[m:] = n_rows                  # padding edges: dropped
    w = rng.normal(size=m + pad).astype(np.float32)
    h = rng.normal(size=(n_cols, d)).astype(np.float32)
    g = rng.normal(size=(n_rows, d)).astype(np.float32)
    return src, dst, w, h, g, n_rows


def _old_route(src, dst, w, h, n_rows):
    """The two-index advanced indexing ``h[pidx, src]`` of earlier PRs."""
    if h.dim() == 2:
        return _old_route(src[None], dst[None], w[None], h[None], n_rows)[0]
    n_parts, d = h.shape[0], h.shape[-1]
    pidx = torch.arange(n_parts)[:, None]
    msgs = h[pidx, src.long()] * w[..., None]
    flat = (pidx * (n_rows + 1) + dst.long()).reshape(-1)
    out = torch.zeros((n_parts * (n_rows + 1), d))
    out.index_add_(0, flat, msgs.reshape(-1, d))
    return out.view(n_parts, n_rows + 1, d)[:, :n_rows]


def _torch_vjp(fn, src, dst, w, h, g, n_rows):
    tw = torch.from_numpy(w).requires_grad_(True)
    th = torch.from_numpy(h).requires_grad_(True)
    out = fn(torch.from_numpy(src), torch.from_numpy(dst), tw, th, n_rows)
    dh, dw = torch.autograd.grad(out, (th, tw), torch.from_numpy(g))
    return out.detach().numpy(), dh.numpy(), dw.numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_coo_spmm_matches_jax_segment_sum_vjp(seed):
    src, dst, w, h, g, n_rows = _coo(seed)

    def jfn(w_, h_):
        return JEdgeListAdj(jnp.asarray(src), jnp.asarray(dst), w_, n_rows,
                            h.shape[0]).spmm(h_)
    jout, vjp = jax.vjp(jfn, jnp.asarray(w), jnp.asarray(h))
    jdw, jdh = vjp(jnp.asarray(g))
    out, dh, dw = _torch_vjp(ops.coo_spmm, src, dst, w, h, g, n_rows)
    np.testing.assert_allclose(out, np.asarray(jout), rtol=0, atol=1e-6)
    np.testing.assert_allclose(dh, np.asarray(jdh), rtol=0, atol=1e-6)
    np.testing.assert_allclose(dw, np.asarray(jdw), rtol=0, atol=1e-6)
    assert not dw[-20:].any(), "padding edges take no gradient"


@pytest.mark.parametrize("stacked", [False, True])
def test_coo_spmm_against_the_two_index_route(stacked):
    """Forward bit-equal, gradients within 1e-6, for 2-D operands and a
    ``[P, ...]`` stack; the backward of ``h`` is an ``index_add_`` (no
    sort-based indexing backward in the graph)."""
    parts = [_coo(s) for s in range(3)]
    if stacked:
        src, dst, w, h, g = (np.stack([p[i] for p in parts])
                             for i in range(5))
    else:
        src, dst, w, h, g = parts[0][:5]
    n_rows = parts[0][5]
    new = _torch_vjp(ops.coo_spmm, src, dst, w, h, g, n_rows)
    old = _torch_vjp(_old_route, src, dst, w, h, g, n_rows)
    np.testing.assert_array_equal(new[0], old[0])
    for a, b in zip(new[1:], old[1:]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    th = torch.from_numpy(h).requires_grad_(True)
    out = ops.coo_spmm(torch.from_numpy(src), torch.from_numpy(dst),
                       torch.from_numpy(w), th, n_rows)
    names, stack = set(), [out.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is not None and type(fn).__name__ not in names:
            names.add(type(fn).__name__)
            stack.extend(f for f, _ in fn.next_functions)
    assert "IndexSelectBackward0" in names
    assert "IndexBackward0" not in names


# ---------------------------------------------------------------------------
# core.halo
# ---------------------------------------------------------------------------

def _partitions(name):
    out = []
    for data, graph in ((jdata, jgraph), (None, tgraph)):
        if name == "rmat":
            g = graph.rmat(360, 2200, seed=3)
            assign = graph.metis_partition(g, 4, seed=3)
        else:
            task = (data or __import__("repro_torch.data",
                                       fromlist=["x"])).make_task(
                "flickr", scale=0.02, feat_dim=16, seed=0)
            g = task.graph
            assign = graph.random_partition(g, 3, seed=1)
        out.append(graph.build_partition(g, assign, hops=1))
    return out


@pytest.mark.parametrize("name", ["rmat", "flickr"])
def test_halo_stats_equal_the_jax_package(name):
    jps, tps = _partitions(name)
    assert tcore.halo_stats(tps).as_dict() == \
        jcore.halo_stats(jps).as_dict()
    from repro.core.halo import duplicate_count, overlap_histogram
    np.testing.assert_array_equal(tcore.overlap_histogram(tps),
                                  overlap_histogram(jps))
    assert tcore.duplicate_count(tps) == duplicate_count(jps)
    assert isinstance(tcore.duplicate_count(tps), int)


# ---------------------------------------------------------------------------
# examples/quickstart_torch.py
# ---------------------------------------------------------------------------

def test_quickstart_runs_on_the_cpu_with_the_plan_figures(capsys):
    epochs = 8
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    got = mod.main(device="cpu", epochs=epochs)
    assert "test acc" in capsys.readouterr().out

    # the JAX quickstart's steps up to its plan, and the bytes it gives
    task = jdata.make_task("flickr", scale=0.05, feat_dim=64, seed=0)
    ps = jgraph.build_partition(
        task.graph, jgraph.metis_partition(task.graph, 4, seed=0), hops=1)
    assert got["halo_stats"] == jcore.halo_stats(ps).as_dict()
    profiles = jcore.make_group(jcore.PAPER_GROUPS["x4"])
    ps = jcore.do_partition(ps, profiles,
                            jcore.RapaConfig(feat_dim=64)).partition_set
    dims = [64, 128, 128]
    cap = jcore.cal_capacity(ps, dims + [task.num_classes], profiles)
    xplan = jdist.build_exchange_plan(
        ps, jcore.build_cache_plan(ps, cap, refresh_every=4))
    ctl = jcore.StalenessController(refresh_every=4)
    refresh = []
    for _ in range(epochs):
        refresh.append(ctl.should_refresh())
        ctl.observe(None, refreshed=refresh[-1])
    assert got["comm_bytes"] == sum(xplan.bytes_per_step(d, r)
                                    for r in refresh for d in dims)
    assert got["comm_bytes_vanilla"] == \
        epochs * sum(xplan.total_halo * d * 4 for d in dims)
    assert (got["refresh_steps"], got["cached_steps"]) == \
        (sum(refresh), epochs - sum(refresh))
    assert np.isfinite(got["final_loss"]) and 0.0 <= got["test_acc"] <= 1.0
