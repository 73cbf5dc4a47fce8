"""The CSR packs of the port's ``d_h`` and hybrid-tail kernel, on the CPU.

- :func:`ops.transpose_csr` holds every live ELL slot and every live tail
  entry of a stacked pack exactly once, and no padding;
  :func:`ops.tail_csr` every live tail entry;
- the row classes (short rows, long-row segments) cover each entry exactly
  once, for thresholds that split rows and thresholds that do not;
- ``ref.csr_spmm_ref`` equals a dense product, in both modes;
- the ELL and hybrid products' forward and ``d_h`` (and ``d_vals``,
  ``d_tail_w``) match ``jax.vjp`` of the JAX package's ``ell_spmm`` and
  ``hybrid_spmm`` (Pallas in interpret mode) within 1e-5, with the packs
  and without them;
- packs are refused where the values they hold need a gradient, and the
  stacked layout's adjacency carries them.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import csr_spmm as kcsr
from repro_torch.kernels import ops, ref
from torch_threads import torch_threads_per_worker  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _stacked_hybrid(seed, n_parts=3, n_rows=50, n_cols=80, m=700,
                    tail_pad=4):
    """A ``[P, ...]`` hybrid pack from skewed random edges; the tails are
    padded with ``tail_dst == n_rows`` entries (``tail_pad`` of them past
    the longest tail), and some ELL slots name columns outside the h
    rows."""
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(n_parts):
        src = rng.integers(0, n_cols, m).astype(np.int32)
        dst = (rng.zipf(1.4, m) % n_rows).astype(np.int32)
        w = rng.normal(size=m).astype(np.float32)
        parts.append(jops.ell_pack_hybrid(src, dst, w, n_rows, quantile=0.7))
    k = max(p[0].shape[1] for p in parts)
    mt = max(p[2].size for p in parts) + tail_pad
    cols = np.zeros((n_parts, n_rows, k), np.int32)
    vals = np.zeros((n_parts, n_rows, k), np.float32)
    ts = np.zeros((n_parts, mt), np.int32)
    td = np.full((n_parts, mt), n_rows, np.int32)
    tw = np.zeros((n_parts, mt), np.float32)
    for i, (c, v, s, d, w) in enumerate(parts):
        cols[i, :, :c.shape[1]], vals[i, :, :v.shape[1]] = c, v
        ts[i, :s.size], td[i, :d.size], tw[i, :w.size] = s, d, w
    h = rng.normal(size=(n_parts, n_cols, 16)).astype(np.float32)
    return cols, vals, ts, td, tw, h


def _entries(pack):
    """The pack's entries as sorted (row, col, w) triples."""
    rowptr = pack.rowptr.numpy()
    rows = np.repeat(np.arange(pack.n_rows), np.diff(rowptr))
    trip = np.stack([rows, pack.col.numpy(), pack.w.numpy()], axis=1)
    return trip[np.lexsort(trip.T[::-1])]


def _sorted(rows, cols, w):
    trip = np.stack([np.asarray(rows, np.float64), np.asarray(cols),
                     np.asarray(w)], axis=1)
    return trip[np.lexsort(trip.T[::-1])]


@pytest.mark.parametrize("backend,tail_pad", [("ell", 0), ("hybrid", 0),
                                              ("hybrid", 5)])
def test_transpose_csr_holds_every_live_entry_once(backend, tail_pad):
    cols, vals, ts, td, tw, _ = _stacked_hybrid(1, tail_pad=tail_pad)
    n_parts, n_rows, _ = cols.shape
    n_cols = 80
    cols[0, 3, 0], vals[0, 3, 0] = n_cols + 2, 1.5   # outside the h rows
    tail = (ts, td, tw) if backend == "hybrid" else ()
    pack = ops.transpose_csr(cols, vals, n_cols, *tail)
    assert (pack.n_rows, pack.n_cols) == (n_parts * n_cols, n_parts * n_rows)
    assert pack.every_row
    rows, tcols, ws = [], [], []
    for p in range(n_parts):
        for i in range(n_rows):
            for k in range(cols.shape[2]):
                c = cols[p, i, k]
                if vals[p, i, k] != 0 and 0 <= c < n_cols:
                    rows.append(p * n_cols + c)
                    tcols.append(p * n_rows + i)
                    ws.append(vals[p, i, k])
        if backend == "hybrid":
            for e in range(ts.shape[1]):
                if td[p, e] < n_rows:
                    rows.append(p * n_cols + ts[p, e])
                    tcols.append(p * n_rows + td[p, e])
                    ws.append(tw[p, e])
    assert pack.nnz == len(ws)
    np.testing.assert_array_equal(_entries(pack), _sorted(rows, tcols, ws))
    assert pack.w.numpy().all(), "ELL padding slots must not enter the pack"


@pytest.mark.parametrize("tail_pad", [0, 5])
def test_tail_csr_holds_every_live_tail_entry_once(tail_pad):
    _, _, ts, td, tw, _ = _stacked_hybrid(2, tail_pad=tail_pad)
    n_parts, n_rows, n_cols = ts.shape[0], 50, 80
    pack = ops.tail_csr(ts, td, tw, n_rows, n_cols)
    assert (pack.n_rows, pack.n_cols) == (n_parts * n_rows, n_parts * n_cols)
    assert not pack.every_row
    q, m = np.nonzero(td < n_rows)
    np.testing.assert_array_equal(
        _entries(pack), _sorted(q * n_rows + td[q, m], q * n_cols + ts[q, m],
                                tw[q, m]))
    listed = np.concatenate([pack.short_rows.numpy(),
                             pack.long_rows.numpy()])
    np.testing.assert_array_equal(np.sort(listed),
                                  np.unique(q * n_rows + td[q, m]))


@pytest.mark.parametrize("every_row", [True, False])
@pytest.mark.parametrize("long_row", [1, 3, 8, 40, 10 ** 6])
def test_row_classes_cover_each_entry_once(long_row, every_row):
    """Short rows and long-row segments together cover each entry of each
    listed row exactly once; short rows hold at most ``long_row`` entries
    and come longest first; segments hold 1..``long_row`` entries and tile
    their row in order."""
    rng = np.random.default_rng(long_row)
    n_rows, n_cols, nnz = 90, 70, 1500
    rows = (rng.zipf(1.3, nnz) % n_rows)
    cols = rng.integers(0, n_cols, nnz)
    pack = ops.csr_pack(rows, cols, rng.normal(size=nnz), n_rows, n_cols,
                        every_row=every_row, long_row=long_row)
    rowptr = pack.rowptr.numpy()
    counts = np.diff(rowptr)
    np.testing.assert_array_equal(counts, np.bincount(rows,
                                                      minlength=n_rows))
    short, long_rows = pack.short_rows.numpy(), pack.long_rows.numpy()
    seg, seg_ptr = pack.seg.numpy(), pack.long_seg_ptr.numpy()
    assert not np.intersect1d(short, long_rows).size
    want = np.arange(n_rows) if every_row else np.flatnonzero(counts)
    np.testing.assert_array_equal(np.sort(np.concatenate([short,
                                                          long_rows])), want)
    assert (counts[short] <= long_row).all()
    assert (np.diff(counts[short]) <= 0).all()        # longest first
    assert (counts[long_rows] > long_row).all()
    covered = np.zeros(pack.nnz, int)
    for r in short:
        covered[rowptr[r]:rowptr[r + 1]] += 1
    assert seg_ptr[0] == 0 and seg_ptr[-1] == seg.shape[0]
    for j, r in enumerate(long_rows):
        segs = seg[seg_ptr[j]:seg_ptr[j + 1]]
        assert segs[0, 0] == rowptr[r] and segs[-1, 1] == rowptr[r + 1]
        np.testing.assert_array_equal(segs[1:, 0], segs[:-1, 1])
        sizes = segs[:, 1] - segs[:, 0]
        assert (sizes >= 1).all() and (sizes <= long_row).all()
        for lo, hi in segs:
            covered[lo:hi] += 1
    assert (covered == 1).all()
    split = (counts > long_row).any()
    assert split == (long_row < counts.max())


def _dense(pack):
    a = np.zeros((pack.n_rows, pack.n_cols), np.float64)
    rows = np.repeat(np.arange(pack.n_rows), np.diff(pack.rowptr.numpy()))
    np.add.at(a, (rows, pack.col.numpy()), pack.w.numpy())
    return a


@pytest.mark.parametrize("every_row,long_row", [(True, 4), (False, 4),
                                                (True, 10 ** 6)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_csr_spmm_ref_equals_dense(every_row, long_row, dtype):
    rng = np.random.default_rng(3)
    n_rows, n_cols, nnz, d = 60, 45, 800, 9
    rows = rng.zipf(1.5, nnz) % n_rows
    pack = ops.csr_pack(rows, rng.integers(0, n_cols, nnz),
                        rng.normal(size=nnz), n_rows, n_cols,
                        every_row=every_row, long_row=long_row)
    x = torch.from_numpy(rng.normal(size=(n_cols, d)).astype(np.float32)
                         ).to(dtype)
    out0 = torch.from_numpy(rng.normal(size=(n_rows, d)).astype(np.float32)
                            ).to(dtype)
    a = _dense(pack)
    prod = a @ x.double().numpy()
    tol = TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    got = ref.csr_spmm_ref(pack, x)
    assert got.dtype == dtype and got.shape == (n_rows, d)
    np.testing.assert_allclose(got.double().numpy(), prod, **tol)
    got = ref.csr_spmm_ref(pack, x, out0)
    np.testing.assert_allclose(got.double().numpy(),
                               out0.double().numpy() + prod, **tol)


def _jax_hybrid_vjp(cols, vals, ts, td, tw, h, g):
    """Per partition: (out, d_vals, d_tail_w, d_h) of ``jax.vjp`` of the
    JAX package's hybrid product."""
    outs = []
    for p in range(cols.shape[0]):
        def f(v, w, x, p=p):
            return jops.hybrid_spmm(jnp.asarray(cols[p]), v,
                                    jnp.asarray(ts[p]), jnp.asarray(td[p]),
                                    w, x, interpret=True)
        out, pull = jax.vjp(f, jnp.asarray(vals[p]), jnp.asarray(tw[p]),
                            jnp.asarray(h[p]))
        outs.append((out, *pull(jnp.asarray(g[p]))))
    return [np.stack([np.asarray(o[i]) for o in outs]) for i in range(4)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_packs", [True, False])
def test_hybrid_forward_and_dh_match_jax_vjp(seed, with_packs):
    cols, vals, ts, td, tw, h = _stacked_hybrid(seed)
    g = np.random.default_rng(seed + 10).normal(
        size=(cols.shape[0], cols.shape[1], h.shape[2])).astype(np.float32)
    want_out, _, _, want_dh = _jax_hybrid_vjp(cols, vals, ts, td, tw, h, g)
    packs = {}
    if with_packs:
        packs = {"tail_pack": ops.tail_csr(ts, td, tw, 50, 80),
                 "dh_pack": ops.transpose_csr(cols, vals, 80, ts, td, tw,
                                              long_row=8)}
    x = torch.from_numpy(h).requires_grad_(True)
    before = ops.pack_for_call.builds
    out = ops.hybrid_spmm(*(torch.from_numpy(a) for a in
                            (cols, vals, ts, td, tw)), x, **packs)
    out.backward(torch.from_numpy(g))
    assert ops.pack_for_call.builds - before == (0 if with_packs else 2)
    np.testing.assert_allclose(out.detach().numpy(), want_out, **TOL)
    np.testing.assert_allclose(x.grad.numpy(), want_dh, **TOL)


def test_hybrid_trained_values_match_jax_vjp():
    """``vals`` and ``tail_w`` with gradients (no packs): ``d_vals``,
    ``d_tail_w`` and ``d_h`` as the JAX package's autodiff gives them."""
    cols, vals, ts, td, tw, h = _stacked_hybrid(4)
    g = np.random.default_rng(5).normal(
        size=(cols.shape[0], cols.shape[1], h.shape[2])).astype(np.float32)
    want = _jax_hybrid_vjp(cols, vals, ts, td, tw, h, g)
    v, w, x = (torch.from_numpy(a).requires_grad_(True) for a in (vals, tw, h))
    out = ops.hybrid_spmm(torch.from_numpy(cols), v, torch.from_numpy(ts),
                          torch.from_numpy(td), w, x)
    out.backward(torch.from_numpy(g))
    for got, exp in zip((out.detach(), v.grad, w.grad, x.grad), want):
        np.testing.assert_allclose(got.numpy(), exp, **TOL)


@pytest.mark.parametrize("n_rows,max_deg,n_cols,d", [(70, 5, 90, 48),
                                                      (128, 9, 300, 128),
                                                      (33, 37, 50, 7)])
def test_ell_forward_and_dh_with_pack_match_jax_vjp(n_rows, max_deg, n_cols,
                                                     d):
    rng = np.random.default_rng(n_rows + d)
    cols = rng.integers(0, n_cols, (n_rows, max_deg)).astype(np.int32)
    vals = rng.normal(size=(n_rows, max_deg)).astype(np.float32)
    vals[rng.random(vals.shape) < 0.3] = 0.0
    h = rng.normal(size=(n_cols, d)).astype(np.float32)
    g = rng.normal(size=(n_rows, d)).astype(np.float32)
    out_j, pull = jax.vjp(lambda x: jops.ell_spmm(jnp.asarray(cols),
                                                  jnp.asarray(vals), x,
                                                  interpret=True),
                          jnp.asarray(h))
    (dh_j,) = pull(jnp.asarray(g))
    pack = ops.transpose_csr(cols, vals, n_cols, long_row=4)
    assert pack.long_rows.numel(), "the case must have long rows"
    x = torch.from_numpy(h).requires_grad_(True)
    out = ops.ell_spmm(torch.from_numpy(cols), torch.from_numpy(vals), x,
                       dh_pack=pack)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(dh_j), **TOL)


@pytest.mark.parametrize("trained", ["vals", "tail_w"])
@pytest.mark.parametrize("pack", ["tail_pack", "dh_pack"])
def test_packs_refused_when_values_need_a_gradient(trained, pack):
    cols, vals, ts, td, tw, h = (torch.from_numpy(a) for a in
                                 _stacked_hybrid(6))
    packs = {"tail_pack": ops.tail_csr(ts, td, tw, 50, 80),
             "dh_pack": ops.transpose_csr(cols, vals, 80, ts, td, tw)}
    operands = {"vals": vals, "tail_w": tw}
    operands[trained] = operands[trained].clone().requires_grad_(True)
    with pytest.raises(ValueError, match="pack"):
        ops.hybrid_spmm(cols, operands["vals"], ts, td, operands["tail_w"],
                        h, **{pack: packs[pack]})
    if trained == "vals" and pack == "dh_pack":
        with pytest.raises(ValueError, match="pack"):
            ops.ell_spmm(cols, operands["vals"], h,
                         dh_pack=ops.transpose_csr(cols, vals, 80))


def test_csr_write_mode_needs_every_row():
    _, _, ts, td, tw, _ = _stacked_hybrid(7)
    with pytest.raises(ValueError, match="every row"):
        kcsr.csr_spmm(ops.tail_csr(ts, td, tw, 50, 80),
                      torch.zeros((3 * 80, 4)))


def test_csr_pack_refuses_ids_past_int32():
    with pytest.raises(ValueError, match="int32"):
        ops.csr_pack([0], [5], [1.0], 4, 2 ** 31, every_row=True)
    with pytest.raises(ValueError, match="int32"):
        ops.csr_pack([0], [0], [1.0], 2 ** 31, 4, every_row=False)
    with pytest.raises(ValueError, match="outside"):
        ops.csr_pack([0, 9], [0, 1], [1.0, 2.0], 4, 4, every_row=False)


@pytest.mark.parametrize("backend", ["ell", "hybrid"])
def test_adj_builder_carries_packs(backend):
    """The stacked layout's adjacency hands the kernels the transposed
    pack (and the tail's CSR), built once where the pack goes to the
    device; without ``grad`` (the serving precompute) no transposed pack
    is built."""
    from repro_torch.dist import make_adj_builder
    from repro_torch.launch.train import build_parser, prepare_train

    args = build_parser().parse_args(
        ["gnn", "--device", "cpu", "--scale", "0.01", "--feat-dim", "16",
         "--hidden", "16", "--backend", backend, "--epochs", "1"])
    sp = prepare_train(args)["sp"]
    n_cols = sp.n_inner_max + sp.n_halo_max
    ell = sp.ell
    tail = (ell.tail_src, ell.tail_dst, ell.tail_w) if backend == "hybrid" \
        else ()
    leaves, build = make_adj_builder(sp, backend, device="cpu")
    adj = build(leaves)
    assert adj.dh_pack is leaves["dh_pack"]
    want = ops.transpose_csr(ell.cols, ell.vals, n_cols, *tail)
    np.testing.assert_array_equal(_entries(adj.dh_pack), _entries(want))
    if backend == "hybrid":
        assert adj.tail_pack is leaves["tail_pack"]
        np.testing.assert_array_equal(
            _entries(adj.tail_pack),
            _entries(ops.tail_csr(*tail, sp.n_inner_max, n_cols)))
    leaves, build = make_adj_builder(sp, backend, device="cpu", grad=False)
    assert build(leaves).dh_pack is None
