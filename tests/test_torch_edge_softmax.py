"""GAT's edge softmax over the edge list's packs, on the CPU, against the
JAX package.

``ops.edge_attention`` (the card's route: ``csrc/edge_softmax.cu`` and the
CSR kernel; here their plain versions over the same packs,
``ref.edge_softmax_ref`` / ``ref.edge_softmax_bwd_ref``) against the JAX
GAT layer's ``segment_max``, ``exp``, ``segment_sum`` and head loop
(``src/repro/models/gnn.py:276-286``) and ``jax.value_and_grad`` of it:

- the layer's output and the gradients of ``w``, ``a_src``, ``a_dst`` and
  ``proj``, partition by partition on the live edges and on the stacked
  ``[P, m]`` form with padding edges (where the JAX package's gradients
  are finite: each partition's last inner row has an edge, ROADMAP queue 3
  item 2), with 1 and 4 heads and a head width of 1 (GAT's last layer);
  every partition has a row longer than ``ops.LONG_ROW`` and an empty row;
- the attention itself and the plain backward's pieces (``d_e_src``,
  ``d_e_dst`` and the attention in ``A^T``'s order) against JAX's segment
  softmax and ``jax.vjp`` of it, at every long-row cut;
- the plain versions over rows of every group width of the card's
  kernels (0 to 257 entries, and a long row of 40 segments) against JAX,
  and those kernels' host-side fields (``CsrPack.runs`` / ``run_warps``
  / ``short_span`` / ``seg_long``), ``csr_pack`` against
  ``csr_pack_torch`` field for field, walked as the kernels walk them;
- the packs' entry map against an explicit inverse of ``perm``;
- ``_gat`` with packs makes exactly one ``ops.edge_attention`` call a
  layer and never the plain route (``_edge_rows`` / ``_edge_softmax``);
  ``edge_dvals_ref(..., a_order=True)`` is the edge-order result in the
  pack's order; the route's refusals.

Tolerance: 1e-5 of the largest magnitude (f32 sums in other orders), as
``tests/test_torch_edge_heads.py``.  The kernels themselves run only on
the card (``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import gnn as jgnn
from repro_torch.kernels import ops, ref
from repro_torch.models import gnn as tgnn
from torch_threads import torch_threads_per_worker  # noqa: F401

N_PARTS, N_ROWS, N_COLS, M = 3, 40, 70, 900
LONG_IN = 300          # edges into row 5: longer than ops.LONG_ROW
EMPTY_ROW = 3
IN_DIM = 12


def _close_of_max(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    tol = 1e-5 * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0.0, atol=tol, err_msg=what)


def _edges(seed, pad=True):
    """A stacked edge list ``[P, m]``: power-law in-degrees, row 5 with
    ``LONG_IN`` edges, row 3 empty, the last inner row with an edge, and
    (``pad``) 10 padding edges a partition (``dst == n_rows``, weight 0)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N_COLS, (N_PARTS, M))
    dst = rng.zipf(1.4, (N_PARTS, M)) % N_ROWS
    dst[:, :LONG_IN] = 5
    dst[dst == EMPTY_ROW] = 6
    dst[:, LONG_IN] = N_ROWS - 1
    if pad:
        dst[:, -10:] = N_ROWS
    w = rng.normal(size=(N_PARTS, M)).astype(np.float32)
    w[dst == N_ROWS] = 0
    return src.astype(np.int64), dst.astype(np.int64), w


def _cfgs(heads, out_dim):
    kw = dict(model="gat", in_dim=IN_DIM, hidden_dim=16, out_dim=out_dim,
              num_layers=1, num_heads=heads)
    return jgnn.GNNConfig(**kw), tgnn.GNNConfig(**kw)


def _params(jcfg):
    return {k: np.asarray(v) for k, v in
            jgnn.init_gnn(jax.random.PRNGKey(5), jcfg)[0].items()}


def _jax_layer(jcfg, p0, src, dst, w, h, g):
    """The JAX GAT layer over one partition's edges: output and
    ``jax.value_and_grad`` of ``sum(out * g)`` in the parameters."""
    jadj = jgnn.EdgeListAdj(jnp.asarray(src), jnp.asarray(dst),
                            jnp.asarray(w), N_ROWS, N_COLS)

    def loss(p_):
        out = jgnn._layer_apply(jcfg, p_, jadj, jnp.asarray(h), N_ROWS, True)
        return jnp.sum(out * g), out
    (_, out), grads = jax.value_and_grad(loss, has_aux=True)(
        jax.tree.map(jnp.asarray, p0))
    return np.asarray(out), {k: np.asarray(v) for k, v in grads.items()}


def _port_layer(tcfg, p0, src, dst, w, h, g):
    """The port's GAT layer over the edge list's packs (``[P, m]`` or
    ``[m]``): output and parameter gradients."""
    edges = [torch.from_numpy(np.ascontiguousarray(a)) for a in (src, dst, w)]
    adj = tgnn.EdgeListAdj(*edges, N_ROWS, N_COLS,
                           ops.edge_packs(*edges, N_ROWS, N_COLS))
    params = {k: torch.from_numpy(v.copy()).requires_grad_(True)
              for k, v in p0.items()}
    out = tgnn._layer_apply(tcfg, params, adj, torch.from_numpy(h), N_ROWS,
                            True)
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach(), {k: v.grad for k, v in params.items()}


# (heads, out_dim): GAT's 4 heads and 1, at a hidden layer's width (16)
# and the last layer's (7 classes: 4 heads of width 1, or 1 of 7; dh =
# max(1, out_dim // heads))
HEAD_CASES = [(4, 16), (1, 16), (4, 7), (1, 7)]


@pytest.mark.parametrize("heads,out_dim", HEAD_CASES)
def test_layer_per_partition_live_edges_matches_jax(heads, out_dim):
    """Each partition's live edges alone (a long row, an empty row): the
    port's layer (``ops.edge_attention`` over the packs) against the JAX
    layer's output and ``value_and_grad``."""
    jcfg, tcfg = _cfgs(heads, out_dim)
    p0 = _params(jcfg)
    assert p0["a_src"].shape == (heads, max(1, out_dim // heads))
    src, dst, w = _edges(1, pad=False)
    rng = np.random.default_rng(2)
    for p in range(N_PARTS):
        h = rng.normal(size=(N_COLS, IN_DIM)).astype(np.float32)
        g = rng.normal(size=(N_ROWS, out_dim)).astype(np.float32)
        jout, jg = _jax_layer(jcfg, p0, src[p], dst[p], w[p], h, g)
        out, grads = _port_layer(tcfg, p0, src[p], dst[p], w[p], h, g)
        _close_of_max(out, jout, f"partition {p} output")
        assert not out[EMPTY_ROW].any()
        for k in ("w", "a_src", "a_dst", "proj"):
            assert np.isfinite(jg[k]).all()
            _close_of_max(grads[k], jg[k], f"partition {p} d{k}")


@pytest.mark.parametrize("heads,out_dim", HEAD_CASES)
def test_stacked_padded_layer_matches_jax_where_finite(heads, out_dim):
    """The stacked ``[P, m]`` edge list with padding edges in one call
    against the JAX layer on each partition's padded edges (finite there:
    every last inner row has an edge): outputs per partition, parameter
    gradients summed over the partitions."""
    jcfg, tcfg = _cfgs(heads, out_dim)
    p0 = _params(jcfg)
    src, dst, w = _edges(3)
    rng = np.random.default_rng(4)
    h = rng.normal(size=(N_PARTS, N_COLS, IN_DIM)).astype(np.float32)
    g = rng.normal(size=(N_PARTS, N_ROWS, out_dim)).astype(np.float32)
    out, grads = _port_layer(tcfg, p0, src, dst, w, h, g)
    want = {k: 0.0 for k in p0}
    for p in range(N_PARTS):
        jout, jg = _jax_layer(jcfg, p0, src[p], dst[p], w[p], h[p], g[p])
        _close_of_max(out[p], jout, f"partition {p} output")
        for k, v in jg.items():
            assert np.isfinite(v).all(), (p, k)
            want[k] = want[k] + v
    for k in ("w", "a_src", "a_dst", "proj"):
        _close_of_max(grads[k], want[k], f"d{k}")


def _jax_segment_softmax(src, dst, es, ed):
    """The JAX layer's attention ``[m, H]`` from per-node scores, as
    ``src/repro/models/gnn.py:278-283`` computes it."""
    logits = jax.nn.leaky_relu(es[src] + ed[dst], 0.2)
    seg_max = jax.ops.segment_max(logits, dst, num_segments=N_ROWS)
    ex = jnp.exp(logits - seg_max[dst])
    denom = jax.ops.segment_sum(ex, dst, num_segments=N_ROWS)
    return ex / jnp.maximum(denom[dst], 1e-9)


@pytest.mark.parametrize("heads", [1, 4])
@pytest.mark.parametrize("long_row", [8, 64, ops.LONG_ROW, 1024])
def test_plain_kernels_match_jax_segment_softmax(heads, long_row):
    """``ref.edge_softmax_ref`` (the forward kernel's plain version) is
    JAX's segment softmax in the pack's order, and
    ``ref.edge_softmax_bwd_ref`` gives ``jax.vjp`` of it in both scores,
    and the attention in ``A^T``'s order, at every long-row cut."""
    src, dst, w = _edges(5, pad=False)
    rng = np.random.default_rng(6)
    es = rng.normal(size=(N_PARTS, N_COLS, heads)).astype(np.float32)
    ed = rng.normal(size=(N_PARTS, N_COLS, heads)).astype(np.float32)
    d_att = rng.normal(size=(N_PARTS, M, heads)).astype(np.float32)
    edges = [torch.from_numpy(a) for a in (src, dst, w)]
    packs = ops.edge_packs(*edges, N_ROWS, N_COLS, long_row=long_row)
    assert (packs.fwd.long_rows.numel() > 0) == (long_row < LONG_IN)
    es_t = torch.from_numpy(es).reshape(-1, heads)
    ed_t = torch.from_numpy(ed).reshape(-1, heads)
    att = ref.edge_softmax_ref(packs.fwd, es_t, ed_t, N_ROWS, N_COLS)
    assert att.shape == (heads, packs.fwd.nnz)
    perm = packs.fwd.perm.long()
    # d_att in the pack's order: edge p * m + e at entry k
    d_att_a = torch.from_numpy(d_att).reshape(-1, heads)[perm].t()
    d_src, d_dst, att_t = ref.edge_softmax_bwd_ref(
        packs.fwd, packs.bwd, packs.amap, att, d_att_a.contiguous(), es_t,
        ed_t, N_ROWS, N_COLS)
    want_att = np.zeros((N_PARTS * M, heads), np.float32)
    want_ds = np.zeros((N_PARTS, N_COLS, heads), np.float32)
    want_dd = np.zeros_like(want_ds)
    for p in range(N_PARTS):
        f = lambda a, b: _jax_segment_softmax(src[p], dst[p], a, b)  # noqa
        a_p, vjp = jax.vjp(f, jnp.asarray(es[p]), jnp.asarray(ed[p]))
        want_att[p * M:(p + 1) * M] = np.asarray(a_p)
        want_ds[p], want_dd[p] = (np.asarray(x) for x in
                                  vjp(jnp.asarray(d_att[p])))
    _close_of_max(att.t(), want_att[perm.numpy()], "attention")
    _close_of_max(d_src.view(N_PARTS, N_COLS, heads), want_ds, "d_e_src")
    _close_of_max(d_dst.view(N_PARTS, N_COLS, heads), want_dd, "d_e_dst")
    assert torch.equal(att_t, att[:, packs.amap.long()])
    # A^T's entry j is the edge bwd.perm[j]: the attention of that edge
    _close_of_max(att_t.t(), want_att[packs.bwd.perm.long().numpy()],
                  "attention in A^T's order")


@pytest.mark.parametrize("long_row", [8, ops.LONG_ROW])
def test_entry_map_is_the_inverse_of_perm(long_row):
    """``edge_packs``' ``amap`` (built once with the packs) is the
    explicit inverse of ``fwd.perm`` read at ``bwd.perm``: A^T's entry j
    and A's entry ``amap[j]`` are the same edge, with the same weight;
    the forward-only packs carry none."""
    src, dst, w = _edges(7)
    edges = [torch.from_numpy(a) for a in (src, dst, w)]
    packs = ops.edge_packs(*edges, N_ROWS, N_COLS, long_row=long_row)
    perm = packs.fwd.perm.numpy()
    inverse = {int(e): k for k, e in enumerate(perm)}
    want = np.array([inverse[int(e)] for e in packs.bwd.perm.numpy()])
    assert packs.amap.dtype == torch.int32
    np.testing.assert_array_equal(packs.amap.numpy(), want)
    np.testing.assert_array_equal(packs.fwd.w.numpy()[want],
                                  packs.bwd.w.numpy())
    assert ops.edge_packs(*edges, N_ROWS, N_COLS, grad=False).amap is None


def test_dvals_in_pack_order_is_the_edge_order_result():
    """``edge_dvals_ref(..., a_order=True)`` (the backward's input) holds
    the edge-order values at ``perm``, head-major ``[H, nnz]``."""
    src, dst, w = _edges(8)
    edges = [torch.from_numpy(a) for a in (src, dst, w)]
    packs = ops.edge_packs(*edges, N_ROWS, N_COLS)
    rng = np.random.default_rng(8)
    g = torch.from_numpy(rng.normal(size=(N_PARTS * N_ROWS, 4, 3)).astype(
        np.float32))
    h = torch.from_numpy(rng.normal(size=(N_PARTS * N_COLS, 4, 3)).astype(
        np.float32))
    n_edges = N_PARTS * M
    by_edge = ref.edge_dvals_ref(packs.fwd, g, h, n_edges)
    in_order = ref.edge_dvals_ref(packs.fwd, g, h, n_edges, a_order=True)
    assert in_order.shape == (4, packs.fwd.nnz)
    assert torch.equal(in_order, by_edge[packs.fwd.perm.long()].t())
    one = ref.edge_dvals_ref(packs.fwd, g[:, 0], h[:, 0], n_edges,
                             a_order=True)
    assert torch.equal(one, in_order[0])


def test_gat_with_packs_makes_one_attention_call_a_layer(monkeypatch):
    """``gnn_forward`` of a 3-layer GAT over an edge list with packs: one
    ``ops.edge_attention`` call a layer, the plain route never (its
    ``_edge_rows`` / ``_edge_softmax`` refuse to run), no per-call gather
    of the values (``ops._valued``), and the logits those of the same
    edge list without packs (the plain route)."""
    calls = []
    edge_attention = ops.edge_attention
    monkeypatch.setattr(ops, "edge_attention", lambda *a: (
        calls.append(a[0].shape), edge_attention(*a))[1])
    src, dst, w = _edges(9)
    edges = [torch.from_numpy(a) for a in (src, dst, w)]
    cfg = tgnn.GNNConfig(model="gat", in_dim=IN_DIM, hidden_dim=16,
                         out_dim=7, num_layers=3)
    params = tgnn.init_gnn(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(9)
    h = torch.from_numpy(rng.normal(size=(N_PARTS, N_ROWS, IN_DIM)).astype(
        np.float32))
    halo = [torch.from_numpy(rng.normal(size=(
        N_PARTS, N_COLS - N_ROWS, d)).astype(np.float32))
        for d in cfg.feat_dims[:cfg.num_layers]]
    plain = tgnn.gnn_forward(cfg, params,
                             tgnn.EdgeListAdj(*edges, N_ROWS, N_COLS), h,
                             halo)
    assert calls == []

    def refuse(*a, **k):
        raise AssertionError("the plain route ran over packs")
    monkeypatch.setattr(tgnn, "_edge_rows", refuse)
    monkeypatch.setattr(tgnn, "_edge_softmax", refuse)
    gathers = ops._valued.gathers
    adj = tgnn.EdgeListAdj(*edges, N_ROWS, N_COLS,
                           ops.edge_packs(*edges, N_ROWS, N_COLS))
    out = tgnn.gnn_forward(cfg, params, adj, h, halo)
    assert calls == [(N_PARTS, N_COLS, cfg.num_heads)] * cfg.num_layers
    assert ops._valued.gathers == gathers
    _close_of_max(out, plain.numpy(), "logits")


def test_edge_attention_refusals():
    """No packs, operands that do not fit the packs, and a gradient over
    forward-only packs raise ``ValueError``."""
    src, dst, w = _edges(10)
    edges = [torch.from_numpy(a) for a in (src, dst, w)]
    es = torch.zeros(N_PARTS, N_COLS, 4)
    hh = torch.zeros(N_PARTS, N_COLS, 4, 2)
    with pytest.raises(ValueError, match="needs the edge list's CSR packs"):
        ops.edge_attention(es, es, hh, None)
    packs = ops.edge_packs(*edges, N_ROWS, N_COLS)
    with pytest.raises(ValueError, match="do not fit"):
        ops.edge_attention(es[:, :-1], es[:, :-1], hh[:, :-1], packs)
    with pytest.raises(ValueError, match="do not fit"):
        ops.edge_attention(es[..., :2], es[..., :2], hh, packs)
    fwd_only = ops.edge_packs(*edges, N_ROWS, N_COLS, grad=False)
    with pytest.raises(ValueError, match="transposed pack"):
        ops.edge_attention(es.requires_grad_(True), es, hh, fwd_only)
    with torch.no_grad():
        out = ops.edge_attention(es, es, hh, fwd_only)
    assert out.shape == (N_PARTS, N_ROWS, 4, 2)


# the row classes of the card's grouping (CsrPack.runs): a row of n
# entries takes the least power of two >= n lanes; rows past the long-row
# cut go over segments (40 of them at long_row 16)
CLASS_LENS = [0, 1, 2, 3, 4, 5, 8, 9, 16, 17, 32, 33, 256, 257, 640]
CLASS_COLS = 300


def _class_edges(seed, n_parts=2):
    """A stacked edge list whose partitions each hold one row of every
    length of :data:`CLASS_LENS` (rows in shuffled order, random
    columns), 7 padding edges a partition."""
    rng = np.random.default_rng(seed)
    n_rows = len(CLASS_LENS)
    m = sum(CLASS_LENS) + 7
    src = rng.integers(0, CLASS_COLS, (n_parts, m))
    dst = np.full((n_parts, m), n_rows)
    for p in range(n_parts):
        rows = rng.permutation(n_rows)
        dst[p, :m - 7] = np.repeat(rows, [CLASS_LENS[r] for r in rows])
    w = np.where(dst < n_rows, 1.0, 0.0).astype(np.float32)
    return src, dst, w, n_rows


def _slots(pack):
    """Each (row, lanes) group the kernel's warps take over ``pack.runs``,
    found as ``find_slot`` in ``csrc/edge_softmax.cu`` finds it: a warp's
    run is the last whose first warp is at most its own."""
    runs = pack.runs.numpy()
    short = pack.short_rows.numpy()
    groups = []
    for w in range(pack.run_warps):
        run = int(np.flatnonzero(runs[:-1, 1] <= w)[-1])
        first, w0, lg = runs[run]
        end = runs[run + 1, 0]
        for slot in range(32 >> lg):
            item = first + ((w - w0) << (5 - lg)) + slot
            if item < end:
                groups.append((int(short[item]), 1 << int(lg)))
    return groups


@pytest.mark.parametrize("long_row", [16, ops.LONG_ROW])
def test_runs_and_segments_cover_the_row_lists(long_row):
    """The host-side fields of the card's edge softmax, for both packs of
    :func:`ops.edge_packs` and for :func:`ops.csr_pack` (numpy) against
    :func:`ops.csr_pack_torch`, field for field: ``runs`` / ``run_warps``
    give every short row with entries exactly one group of the least
    power of two >= its entries of lanes (at most 32), and no group to an
    empty or long row; rows
    of one run share their lanes; ``short_span`` is each short row's
    entry range; the long rows are the rows past ``long_row`` entries,
    and ``seg_long`` names each segment's long row, whose entries the
    row's segments cover in order."""
    src, dst, w, n_rows = _class_edges(11)
    packs = ops.edge_packs(*(torch.from_numpy(a) for a in (src, dst, w)),
                           n_rows, CLASS_COLS, long_row=long_row)
    p, e = np.nonzero(dst < n_rows)
    rows, cols = p * n_rows + dst[p, e], p * CLASS_COLS + src[p, e]
    shape = (2 * n_rows, 2 * CLASS_COLS)
    for pack, args, kw in (
            (packs.fwd, (rows, cols), {}),
            (packs.bwd, (cols, rows), {"col_block": n_rows})):
        by_np = ops.csr_pack(*args, w[p, e], *(shape if not kw else
                                               shape[::-1]),
                             every_row=True, long_row=long_row, **kw)
        for f in ("runs", "short_span", "seg_long", "run_warps",
                  "short_rows", "long_rows", "seg"):
            a, b = getattr(by_np, f), getattr(pack, f)
            assert (torch.equal(a, b) and a.dtype == b.dtype
                    if isinstance(a, torch.Tensor) else a == b), f
        counts = (pack.rowptr[1:] - pack.rowptr[:-1]).numpy()
        groups = _slots(pack)
        got = sorted(r for r, _ in groups)
        want = sorted(int(r) for r in pack.short_rows.numpy()
                      if counts[r] > 0)
        assert got == want
        for r, g in groups:
            n = counts[r]
            assert g == min(32, 1 << int(n - 1).bit_length()), (r, n, g)
        short = pack.short_rows.long()
        assert torch.equal(pack.short_span, torch.stack(
            [pack.rowptr[short], pack.rowptr[short + 1]], dim=1))
        runs = pack.runs.numpy()
        assert runs[-1].tolist() == [pack.short_rows.numel(),
                                     pack.run_warps, 0]
        assert (np.diff(runs[:, 0]) > 0).all()
        assert (np.diff(runs[:, 1]) >= 0).all()
        np.testing.assert_array_equal(pack.long_rows.numpy(),
                                      np.flatnonzero(counts > long_row))
        seg, seg_long = pack.seg.numpy(), pack.seg_long.numpy()
        ptr = pack.long_seg_ptr.numpy()
        assert seg_long.shape == (seg.shape[0],)
        for i, r in enumerate(pack.long_rows.numpy()):
            assert (seg_long[ptr[i]:ptr[i + 1]] == i).all()
            s = seg[ptr[i]:ptr[i + 1]]
            assert s[0, 0] == pack.rowptr[r] and s[-1, 1] == pack.rowptr[r + 1]
            assert (s[1:, 0] == s[:-1, 1]).all()
            assert (s[:, 1] - s[:, 0] <= long_row).all()
    if long_row == 16:
        assert (packs.fwd.long_seg_ptr[1:] - packs.fwd.long_seg_ptr[:-1]
                ).max() == 40


@pytest.mark.parametrize("heads", [1, 4])
@pytest.mark.parametrize("long_row", [16, ops.LONG_ROW])
def test_plain_kernels_match_jax_at_row_classes(heads, long_row):
    """The plain versions against JAX's segment softmax and its vjp over
    rows of every class of the card's grouping (0 to 257 entries, and 640:
    40 segments at long_row 16), each partition on its own."""
    src, dst, w, n_rows = _class_edges(12)
    rng = np.random.default_rng(13)
    n_parts, m = src.shape
    es, ed = (rng.normal(size=(n_parts, CLASS_COLS, heads)).astype(
        np.float32) for _ in range(2))
    d_att = rng.normal(size=(n_parts, m, heads)).astype(np.float32)
    packs = ops.edge_packs(*(torch.from_numpy(a) for a in (src, dst, w)),
                           n_rows, CLASS_COLS, long_row=long_row)
    es_t, ed_t = (torch.from_numpy(a).reshape(-1, heads) for a in (es, ed))
    att = ref.edge_softmax_ref(packs.fwd, es_t, ed_t, n_rows, CLASS_COLS)
    perm = packs.fwd.perm.long()
    d_att_a = torch.from_numpy(d_att).reshape(-1, heads)[perm].t()
    d_src, d_dst, _ = ref.edge_softmax_bwd_ref(
        packs.fwd, packs.bwd, packs.amap, att, d_att_a.contiguous(), es_t,
        ed_t, n_rows, CLASS_COLS)
    want_att = np.zeros((n_parts * m, heads), np.float32)
    want_ds = np.zeros((n_parts, CLASS_COLS, heads), np.float32)
    want_dd = np.zeros_like(want_ds)
    for p in range(n_parts):
        live = dst[p] < n_rows
        s_p, d_p = src[p][live], dst[p][live]

        def f(a, b, s_p=s_p, d_p=d_p):
            logits = jax.nn.leaky_relu(a[s_p] + b[d_p], 0.2)
            mx = jax.ops.segment_max(logits, d_p, num_segments=n_rows)
            ex = jnp.exp(logits - mx[d_p])
            den = jax.ops.segment_sum(ex, d_p, num_segments=n_rows)
            return ex / jnp.maximum(den[d_p], 1e-9)
        a_p, vjp = jax.vjp(f, jnp.asarray(es[p]), jnp.asarray(ed[p]))
        want_att[p * m + np.flatnonzero(live)] = np.asarray(a_p)
        want_ds[p], want_dd[p] = (np.asarray(x) for x in vjp(
            jnp.asarray(d_att[p][live])))
    _close_of_max(att.t(), want_att[perm.numpy()], "attention")
    _close_of_max(d_src.view(n_parts, CLASS_COLS, heads), want_ds, "d_e_src")
    _close_of_max(d_dst.view(n_parts, CLASS_COLS, heads), want_dd, "d_e_dst")
