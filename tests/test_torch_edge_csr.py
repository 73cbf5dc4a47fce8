"""The edge list's CSR route (``ops.edge_packs``, ``ops.EdgeSpmmFn``) on
the CPU, against the JAX package's ``EdgeListAdj``.

On the card every edge-list aggregation (the ``edges`` backend, GAT's
``spmm_at``, the 1.5D strategy's chunk, the serving engine's fresh
recompute) is the CSR kernel over the edge list's forward pack, its
``d_h`` the same kernel over the transposed pack, and its per-edge
values' cotangent ``csrc/edge_dvals.cu``.  Their plain versions
(``ref.csr_spmm_ref``, ``ref.edge_dvals_ref``) over the same packs are
held here to ``jax.vjp`` of the JAX package's ``EdgeListAdj.spmm`` /
``spmm_at`` within 1e-5, on a stacked layout with padding edges
(``dst == n_rows``), long rows cut into segments, and empty rows:

- the forward pack, the transposed pack's ``d_h`` and the plain
  ``d_e_vals`` (0 at padding edges), and ``EdgeSpmmFn`` through autograd;
- ``perm`` puts per-call values in pack order;
- ``csr_pack_torch`` (and so ``edge_packs``, which builds with it on
  the edge list's device) equals the host builder ``csr_pack`` field for
  field;
- the 1.5D chunk's packs against the JAX layout's ``segment_sum``;
- the stacked runtime's, ``make_local_adj``'s and the serving engine's
  edge lists carry their packs, and an edge list off the CPU without
  packs raises;
- ``launch.mesh.make_device_mesh`` defaults to ``"cuda"`` and raises
  without a card.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import strategy_15d as j15
from repro.dist.spec import TrainSpec as JSpec
from repro.models import gnn as jgnn
from repro_torch import core as tcore
from repro_torch.data.gnn_data import make_task
from repro_torch.dist import (TrainSpec, build_exchange_plan,
                              make_adj_builder, stack_partitions)
from repro_torch.dist import strategy_15d as t15
from repro_torch.graph import build_partition, metis_partition
from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import make_device_mesh
from repro_torch.models import gnn as tgnn
from repro_torch.serve import GNNServeEngine, precompute_embeddings
from repro_torch.serve import engine as tengine
from torch_threads import torch_threads_per_worker  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
N_PARTS, N_ROWS, N_COLS, M, D = 3, 40, 70, 900, 8


def _edges(seed, n_parts=N_PARTS, n_rows=N_ROWS, n_cols=N_COLS, m=M, d=D):
    """A stacked edge list ``[P, m]`` with skewed in-degrees, padding edges
    (``dst == n_rows``, weight 0; the last 5 of each partition, as
    ``stack_partitions`` pads), an empty row 3 and unused columns; ``h``,
    ``g`` and per-edge values."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_cols - 5, (n_parts, m)).astype(np.int32)
    dst = (rng.zipf(1.3, (n_parts, m)) % (n_rows + 1)).astype(np.int32)
    dst[dst == 3] = 4
    dst[:, -5:] = n_rows
    w = rng.normal(size=(n_parts, m)).astype(np.float32)
    w[dst == n_rows] = 0
    h = rng.normal(size=(n_parts, n_cols, d)).astype(np.float32)
    g = rng.normal(size=(n_parts, n_rows, d)).astype(np.float32)
    e_vals = rng.normal(size=(n_parts, m)).astype(np.float32)
    return src, dst, w, h, g, e_vals


def _jadj(src, dst, w, p):
    return jgnn.EdgeListAdj(jnp.asarray(src[p]), jnp.asarray(dst[p]),
                            jnp.asarray(w[p]), N_ROWS, N_COLS)


def _packs(src, dst, w, **kw):
    """``ops.edge_packs`` of numpy edge arrays (CPU tensors)."""
    return ops.edge_packs(*(torch.from_numpy(a) for a in (src, dst, w)),
                          N_ROWS, N_COLS, **kw)


def _host_packs(src, dst, w, long_row=ops.LONG_ROW):
    """The forward and transposed packs built on the host with
    ``ops.csr_pack`` from the live edges: the reference of
    ``edge_packs``."""
    p, e = np.nonzero(dst < N_ROWS)
    rows, cols = p * N_ROWS + dst[p, e], p * N_COLS + src[p, e]
    shape = (N_PARTS * N_ROWS, N_PARTS * N_COLS)
    kw = dict(every_row=True, long_row=long_row, ids=p * M + e)
    return (ops.csr_pack(rows, cols, w[p, e], *shape, **kw),
            ops.csr_pack(cols, rows, w[p, e], *shape[::-1], **kw))


def _close(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), err_msg=what, **TOL)


LONG_ROWS = [16, 1024]   # rows cut into segments, and not


@pytest.mark.parametrize("long_row", LONG_ROWS)
def test_forward_pack_is_jax_spmm(long_row):
    src, dst, w, h, _, _ = _edges(0)
    packs = _packs(src, dst, w, long_row=long_row)
    fwd = packs.fwd
    assert (fwd.n_rows, fwd.n_cols) == (N_PARTS * N_ROWS, N_PARTS * N_COLS)
    assert fwd.nnz == int((dst < N_ROWS).sum()) and fwd.every_row
    assert (fwd.seg.shape[0] > 0) == (long_row == 16)
    got = ref.csr_spmm_ref(fwd, torch.from_numpy(h).reshape(-1, D))
    for p in range(N_PARTS):
        want = _jadj(src, dst, w, p).spmm(jnp.asarray(h[p]))
        _close(got[p * N_ROWS:(p + 1) * N_ROWS], want, f"partition {p}")


@pytest.mark.parametrize("long_row", LONG_ROWS)
def test_transposed_pack_is_jax_vjp_dh(long_row):
    src, dst, w, h, g, _ = _edges(1)
    packs = _packs(src, dst, w, long_row=long_row)
    assert (packs.bwd.n_rows, packs.bwd.n_cols) == (N_PARTS * N_COLS,
                                                    N_PARTS * N_ROWS)
    got = ref.csr_spmm_ref(packs.bwd, torch.from_numpy(g).reshape(-1, D))
    for p in range(N_PARTS):
        _, vjp = jax.vjp(_jadj(src, dst, w, p).spmm, jnp.asarray(h[p]))
        want = vjp(jnp.asarray(g[p]))[0]
        _close(got[p * N_COLS:(p + 1) * N_COLS], want, f"partition {p}")
    assert not got[N_COLS - 5:N_COLS].any()   # unused columns: zero rows


@pytest.mark.parametrize("long_row", LONG_ROWS)
def test_edge_dvals_ref_is_jax_grad_of_spmm_at(long_row):
    src, dst, w, h, g, e_vals = _edges(2)
    packs = _packs(src, dst, w, long_row=long_row)
    got = ref.edge_dvals_ref(packs.fwd, torch.from_numpy(g).reshape(-1, D),
                             torch.from_numpy(h).reshape(-1, D),
                             N_PARTS * M).view(N_PARTS, M)
    for p in range(N_PARTS):
        adj = _jadj(src, dst, w, p)
        _, vjp = jax.vjp(lambda e: adj.spmm_at(e, jnp.asarray(h[p])),
                         jnp.asarray(e_vals[p]))
        _close(got[p], vjp(jnp.asarray(g[p]))[0], f"partition {p}")
    pad = torch.from_numpy(dst == N_ROWS)
    assert pad.any() and not got[pad].any()


def test_perm_puts_per_call_values_in_pack_order():
    src, dst, w, h, _, e_vals = _edges(3)
    packs = _packs(src, dst, w, long_row=16)
    for pack, (rows, cols) in ((packs.fwd, (dst, src)),
                               (packs.bwd, (src, dst))):
        n_r = pack.n_rows // N_PARTS
        n_c = pack.n_cols // N_PARTS
        perm = pack.perm.long().numpy()
        p, e = np.divmod(perm, M)
        entry_rows = np.repeat(np.arange(pack.n_rows),
                               np.diff(pack.rowptr.numpy()))
        np.testing.assert_array_equal(entry_rows, p * n_r + rows[p, e])
        np.testing.assert_array_equal(pack.col.numpy(), p * n_c + cols[p, e])
        np.testing.assert_array_equal(pack.w.numpy(), w[p, e])
        valued = ops._valued(pack, torch.from_numpy(e_vals))
        np.testing.assert_array_equal(valued.w.numpy(), e_vals[p, e])
        assert sorted(perm) == sorted(np.flatnonzero(dst.ravel() < N_ROWS))
    got = ref.csr_spmm_ref(ops._valued(packs.fwd, torch.from_numpy(e_vals)),
                           torch.from_numpy(h).reshape(-1, D))
    for p in range(N_PARTS):
        want = _jadj(src, dst, w, p).spmm_at(jnp.asarray(e_vals[p]),
                                             jnp.asarray(h[p]))
        _close(got[p * N_ROWS:(p + 1) * N_ROWS], want, f"partition {p}")


@pytest.mark.parametrize("at", [False, True], ids=["spmm", "spmm_at"])
def test_edge_spmm_fn_is_jax_vjp(at):
    """``EdgeSpmmFn`` on CPU tensors (the plain versions over the packs):
    the forward, ``d_h`` and ``d_e_vals`` against ``jax.vjp``."""
    src, dst, w, h, g, e_vals = _edges(4)
    packs = _packs(src, dst, w, long_row=16)
    ht = torch.from_numpy(h).requires_grad_(True)
    et = torch.from_numpy(e_vals).requires_grad_(True) if at else None
    out = ops.EdgeSpmmFn.apply(et, ht, packs)
    grads = torch.autograd.grad(out, [ht] + ([et] if at else []),
                                torch.from_numpy(g))
    for p in range(N_PARTS):
        adj = _jadj(src, dst, w, p)
        if at:
            want, vjp = jax.vjp(adj.spmm_at, jnp.asarray(e_vals[p]),
                                jnp.asarray(h[p]))
            d_e, d_h = vjp(jnp.asarray(g[p]))
            _close(grads[1][p], d_e, f"d_e_vals {p}")
        else:
            want, vjp = jax.vjp(adj.spmm, jnp.asarray(h[p]))
            (d_h,) = vjp(jnp.asarray(g[p]))
        _close(out[p], want, f"forward {p}")
        _close(grads[0][p], d_h, f"d_h {p}")


def test_edge_spmm_fn_refuses_what_does_not_fit():
    src, dst, w, h, _, _ = _edges(5)
    packs = _packs(src, dst, w, grad=False)
    assert packs.bwd is None
    ops.edge_spmm(torch.from_numpy(h), packs)           # no gradient: fine
    with pytest.raises(ValueError, match="transposed pack"):
        ops.edge_spmm(torch.from_numpy(h).requires_grad_(True), packs)
    with pytest.raises(ValueError, match="do not fit"):
        ops.edge_spmm(torch.from_numpy(h[:2]), packs)
    with pytest.raises(ValueError, match="do not fit"):
        ops.edge_spmm(torch.from_numpy(h), packs, torch.ones(N_PARTS, M + 1))


def _same_pack(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("every_row", [True, False])
@pytest.mark.parametrize("long_row", [8, 64, ops.LONG_ROW])
def test_csr_pack_torch_is_csr_pack(every_row, long_row):
    rng = np.random.default_rng(6)
    n_rows, n_cols, nnz = 55, 60, 3000
    rows = rng.integers(0, 50, nnz)        # rows 50-54 empty
    rows[:500] = 7                         # one long row
    cols = rng.integers(0, n_cols, nnz)
    w = rng.normal(size=nnz).astype(np.float32)
    ids = rng.permutation(nnz)
    want = ops.csr_pack(rows, cols, w, n_rows, n_cols, every_row, long_row,
                        ids=ids)
    got = ops.csr_pack_torch(*(torch.from_numpy(a) for a in (rows, cols, w)),
                             n_rows, n_cols, every_row, long_row,
                             ids=torch.from_numpy(ids))
    _same_pack(got, want)
    assert (want.seg.shape[0] > 0) == (long_row < 500)
    assert ops.csr_pack_torch(torch.zeros(0, dtype=torch.long),
                              torch.zeros(0, dtype=torch.long),
                              torch.zeros(0), 4, 5, every_row).nnz == 0
    with pytest.raises(ValueError, match="outside"):
        ops.csr_pack_torch(torch.tensor([0, n_rows]), torch.tensor([0, 1]),
                           torch.ones(2), n_rows, n_cols, every_row)


@pytest.mark.parametrize("long_row", LONG_ROWS)
def test_edge_packs_are_the_host_packs(long_row):
    """``edge_packs`` (torch ops on the edge list's device) gives the
    packs ``csr_pack`` builds on the host from the live edges, field for
    field."""
    src, dst, w, _, _, _ = _edges(7)
    got = _packs(src, dst, w, long_row=long_row)
    want = _host_packs(src, dst, w, long_row)
    _same_pack(got.fwd, want[0])
    _same_pack(got.bwd, want[1])
    assert (got.n_parts, got.n_rows, got.n_cols, got.n_edges) == \
        (N_PARTS, N_ROWS, N_COLS, M)
    one = ops.edge_packs(*(torch.from_numpy(a[0]) for a in (src, dst, w)),
                         N_ROWS, N_COLS, grad=False)
    assert one.n_parts == 1 and one.bwd is None
    assert one.fwd.nnz == int((dst[0] < N_ROWS).sum())


def _task_and_parts(parts):
    task = make_task("flickr", scale=0.01, feat_dim=16, seed=0)
    return task, build_partition(task.graph, metis_partition(
        task.graph, parts, seed=0), hops=1)


@pytest.mark.parametrize("c,pr", [(1, 2), (2, 2)])
def test_chunk_adj_15d_is_jax_chunk_segment_sum(c, pr):
    """Each rank's chunk (``strategy_15d.chunk_adj``): its forward pack's
    product and its transposed pack's ``d_h`` against the JAX layout's
    ``segment_sum`` aggregation of the same rank and ``jax.vjp`` of it."""
    task, ps = _task_and_parts(pr)
    tl = t15.build_spmm15d_layout(ps, task, TrainSpec(strategy="spmm_15d",
                                                      replication=c))
    jl = j15.build_spmm15d_layout(ps, task, JSpec(strategy="spmm_15d",
                                                  replication=c))
    ni, n_cols = tl.ni, tl.g * tl.ni
    rng = np.random.default_rng(8)
    for rank in range(tl.n_devices):
        adj = t15.chunk_adj(tl, rank, "cpu")
        m = int(jl.n_edges_dev[rank])
        assert adj.packs.fwd.nnz == m and (adj.n_rows, adj.n_cols) == \
            (ni, n_cols)
        src, dst, w = (jnp.asarray(a[rank]) for a in (
            jl.chunk_src, jl.chunk_dst, jl.chunk_w))

        def agg(hg):
            msgs = hg[src] * w[:, None]
            return jax.ops.segment_sum(msgs, dst, num_segments=ni + 1)[:ni]
        hg = rng.normal(size=(n_cols, 6)).astype(np.float32)
        g = rng.normal(size=(ni, 6)).astype(np.float32)
        want, vjp = jax.vjp(agg, jnp.asarray(hg))
        _close(ref.csr_spmm_ref(adj.packs.fwd, torch.from_numpy(hg)), want,
               f"rank {rank}")
        _close(ref.csr_spmm_ref(adj.packs.bwd, torch.from_numpy(g)),
               vjp(jnp.asarray(g))[0], f"rank {rank} d_h")
        _close(adj.spmm(torch.from_numpy(hg)), want, f"rank {rank} spmm")


@pytest.mark.parametrize("grad", [True, False])
def test_stacked_and_local_edge_lists_carry_their_packs(grad):
    task, ps = _task_and_parts(2)
    sp = stack_partitions(ps, task, backend="edges")
    leaves, build = make_adj_builder(sp, "edges", "cpu", grad=grad)
    adj = build(leaves)
    ni, nc = sp.n_inner_max, sp.n_inner_max + sp.n_halo_max
    p, e = np.nonzero(sp.e_dst < ni)
    rows, cols = p * ni + sp.e_dst[p, e], p * nc + sp.e_src[p, e]
    kw = dict(every_row=True, ids=p * sp.e_src.shape[1] + e)
    _same_pack(adj.packs.fwd, ops.csr_pack(
        rows, cols, sp.e_w[p, e], sp.num_parts * ni, sp.num_parts * nc,
        **kw))
    assert (adj.packs.bwd is None) == (not grad)
    if grad:
        _same_pack(adj.packs.bwd, ops.csr_pack(
            cols, rows, sp.e_w[p, e], sp.num_parts * nc, sp.num_parts * ni,
            **kw))
    h = torch.from_numpy(np.random.default_rng(9).normal(
        size=(sp.num_parts, nc, 5)).astype(np.float32))
    _close(ops.EdgeSpmmFn.apply(None, h, adj.packs), adj.spmm(h))
    part = ps.parts[0]
    local = tgnn.make_local_adj(part.local_graph, part.n_inner, "edges",
                                device="cpu")
    assert local.packs.fwd.nnz == local.src.numel()
    h = torch.from_numpy(np.random.default_rng(10).normal(
        size=(part.n_local, 5)).astype(np.float32))
    _close(ops.EdgeSpmmFn.apply(None, h, local.packs), local.spmm(h))


@pytest.mark.parametrize("at", [False, True], ids=["spmm", "spmm_at"])
def test_edge_list_without_packs_raises_off_the_cpu(at):
    """An edge list whose tensors are not on the CPU (``meta`` here: no
    card needed) takes the kernels' route, which needs the packs: without
    them it raises, and nothing falls back to ``coo_spmm``."""
    meta = dict(device="meta")
    adj = tgnn.EdgeListAdj(torch.zeros(10, dtype=torch.long, **meta),
                           torch.zeros(10, dtype=torch.long, **meta),
                           torch.ones(10, **meta), 4, 6)
    h = torch.zeros(6, 3, **meta)
    with pytest.raises(ValueError, match="needs its CSR packs"):
        adj.spmm_at(torch.ones(10, **meta), h) if at else adj.spmm(h)


def test_fresh_recompute_builds_its_pack_from_its_subgraph(monkeypatch):
    """The serving engine's recompute hands ``gnn_forward`` an edge list
    with the subgraph's packs (``edge_packs``, forward only, built per
    call), equal to ``csr_pack`` of the same edges on the host; over them
    ``EdgeSpmmFn`` equals ``coo_spmm``."""
    task, ps = _task_and_parts(4)
    cfg = tgnn.GNNConfig(model="gcn", in_dim=16, hidden_dim=16,
                         out_dim=task.num_classes, num_layers=2)
    params = tgnn.init_gnn(cfg, torch.Generator().manual_seed(0), "cpu")
    cap = tcore.cal_capacity(ps, cfg.feat_dims, tcore.make_group(
        tcore.PAPER_GROUPS["x4"]), m_cpu_gib=4.0)
    xplan = build_exchange_plan(ps, tcore.build_cache_plan(
        ps, cap, refresh_every=4))
    store = precompute_embeddings(
        cfg, ps, stack_partitions(ps, task, backend="edges"), xplan, params,
        backend="edges", device="cpu")
    engine = GNNServeEngine(store, params, task.graph, np.arange(10),
                            features=task.features, device="cpu")
    upd = np.array([3, 50])
    engine.update_features(upd, task.features[upd] + 1.0)
    seen = []
    forward = tengine.gnn_forward

    def spy(cfg_, params_, adj, h_inner, halo):
        seen.append(adj)
        return forward(cfg_, params_, adj, h_inner, halo)
    monkeypatch.setattr(tengine, "gnn_forward", spy)
    engine.query(np.flatnonzero(engine.stale)[:8])
    assert len(seen) == 1
    adj = seen[0]
    assert adj.packs.bwd is None
    src, dst = adj.src.numpy(), adj.dst.numpy()
    _same_pack(adj.packs.fwd, ops.csr_pack(
        dst, src, adj.weight.numpy(), adj.n_rows, adj.n_cols, True,
        ids=np.arange(src.size)))
    h = torch.from_numpy(np.random.default_rng(11).normal(
        size=(adj.n_cols, 5)).astype(np.float32))
    _close(ops.EdgeSpmmFn.apply(None, h, adj.packs), adj.spmm(h))


def test_device_mesh_defaults_to_the_card(monkeypatch):
    """``make_device_mesh`` asks for ``"cuda"`` unless told otherwise and
    raises where CUDA is not available, rather than falling to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_device_mesh((1,), ("data",))
