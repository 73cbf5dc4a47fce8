"""The edge route's packs and GAT's heads in one call, on the CPU, against
the JAX package; and the profilers' device-busy sum.

- ``csr_pack(..., col_block=)`` and ``csr_pack_torch`` list the short rows
  block by block (a stacked layout's partitions), longest first within a
  block, empty rows last, and agree field for field; ``edge_packs``'
  transposed pack is in that order, its forward pack longest first over
  the stack; the plain products over them equal JAX's ``segment_sum``
  and its VJP;
- ``spmm_at`` with ``e_vals [(P,) m, H]`` and ``h [(P,) n, H, dh]``:
  its output, ``d_h`` and ``d_vals [m, H]`` against ``jax.vjp`` of the
  reference's loop over the heads (``src/repro/models/gnn.py:284-286``),
  through the packs' route (``ops.edge_spmm``, the card's, here on its
  plain versions) and the CPU's ``coo_spmm`` loop;
- the port's GAT layer, which makes one ``ops.edge_attention`` call for
  all its heads over the packs (one ``spmm_at`` without them), against
  the JAX GAT layer where the JAX package is finite
  (ROADMAP queue 3 item 2: each partition's edges trimmed to
  ``dst < n_inner_max``);
- ``launch.profile_serve._summary`` adds the device time of kernels,
  copies and memsets, and lists a ``record_function`` range's device
  side apart.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import gnn as jgnn
from repro_torch.kernels import ops, ref
from repro_torch.launch import profile_serve
from repro_torch.models import gnn as tgnn
from torch_threads import torch_threads_per_worker  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
N_PARTS, N_ROWS, N_COLS, M, H, DH = 3, 40, 70, 900, 4, 6


def _close(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), err_msg=what, **TOL)


def _edges(seed):
    """A stacked edge list ``[P, m]`` with skewed in-degrees, padding edges
    (``dst == n_rows``, weight 0, the last 5 of each partition), an empty
    row 3 and unused columns; ``h``, ``g`` and per-edge, per-head
    values."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N_COLS - 5, (N_PARTS, M)).astype(np.int32)
    dst = (rng.zipf(1.3, (N_PARTS, M)) % (N_ROWS + 1)).astype(np.int32)
    dst[dst == 3] = 4
    dst[:, -5:] = N_ROWS
    w = rng.normal(size=(N_PARTS, M)).astype(np.float32)
    w[dst == N_ROWS] = 0
    h = rng.normal(size=(N_PARTS, N_COLS, H, DH)).astype(np.float32)
    g = rng.normal(size=(N_PARTS, N_ROWS, H, DH)).astype(np.float32)
    e_vals = rng.normal(size=(N_PARTS, M, H)).astype(np.float32)
    return src, dst, w, h, g, e_vals


def _packs(src, dst, w, long_row=ops.LONG_ROW):
    return ops.edge_packs(*(torch.from_numpy(a) for a in (src, dst, w)),
                          N_ROWS, N_COLS, long_row=long_row)


def _same_pack(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), f.name
        else:
            assert x == y, f.name


def _row_order_holds(pack, col_block=None):
    """The short rows go block by block (that of their first column),
    longest first within a block, empty rows after every block; without
    ``col_block``, longest first over the whole stack."""
    rowptr, col = pack.rowptr.long(), pack.col.long()
    short = pack.short_rows.long()
    counts = (rowptr[1:] - rowptr[:-1])[short]
    if col_block is None:
        assert (counts[1:] <= counts[:-1]).all()
        return
    first = torch.cat([col, col.new_zeros(1)])[rowptr[:-1][short]]
    n_blocks = -(-pack.n_cols // col_block)
    block = torch.where(counts > 0, first // col_block, n_blocks)
    assert (block[1:] >= block[:-1]).all()
    same = block[1:] == block[:-1]
    assert (counts[1:][same] <= counts[:-1][same]).all()


@pytest.mark.parametrize("col_block", [1, 7, 20, 60])
@pytest.mark.parametrize("long_row", [8, 64, ops.LONG_ROW])
@pytest.mark.parametrize("every_row", [True, False])
def test_col_block_order_torch_is_csr_pack(every_row, long_row, col_block):
    """The blocked row order: ``csr_pack_torch`` equals ``csr_pack`` field
    for field, both in that order, over the same rows as the order
    without blocks."""
    rng = np.random.default_rng(long_row + col_block)
    n_rows, n_cols, nnz = 55, 60, 3000
    rows = rng.integers(0, 50, nnz)        # rows 50-54 empty
    rows[:500] = 7                         # one long row
    cols = rng.integers(0, n_cols, nnz)
    w = rng.normal(size=nnz).astype(np.float32)
    ids = rng.permutation(nnz)
    want = ops.csr_pack(rows, cols, w, n_rows, n_cols, every_row, long_row,
                        ids=ids, col_block=col_block)
    got = ops.csr_pack_torch(*(torch.from_numpy(a) for a in (rows, cols, w)),
                             n_rows, n_cols, every_row, long_row,
                             ids=torch.from_numpy(ids), col_block=col_block)
    _same_pack(got, want)
    _row_order_holds(want, col_block)
    plain = ops.csr_pack(rows, cols, w, n_rows, n_cols, every_row, long_row,
                         ids=ids)
    assert torch.equal(torch.sort(want.short_rows).values,
                       torch.sort(plain.short_rows).values)
    for f in ("rowptr", "col", "w", "seg", "long_rows", "perm"):
        assert torch.equal(getattr(want, f), getattr(plain, f)), f
    with pytest.raises(ValueError, match="col_block"):
        ops.csr_pack(rows, cols, w, n_rows, n_cols, every_row, col_block=0)


@pytest.mark.parametrize("long_row", [16, 1024])
def test_blocked_edge_packs_product_is_jax_segment_sum(long_row):
    """``edge_packs`` lists the transposed pack's rows partition by
    partition (by the partition's rows), the forward pack's longest first
    over the stack; the plain products over them equal JAX's
    ``segment_sum`` and ``jax.vjp`` of it, partition by partition."""
    src, dst, w, h, g, _ = _edges(1)
    h, g = h[..., 0, :], g[..., 0, :]
    packs = _packs(src, dst, w, long_row)
    _row_order_holds(packs.fwd)
    _row_order_holds(packs.bwd, N_ROWS)
    fwd = ref.csr_spmm_ref(packs.fwd, torch.from_numpy(h).reshape(-1, DH))
    d_h = ref.csr_spmm_ref(packs.bwd, torch.from_numpy(g).reshape(-1, DH))
    for p in range(N_PARTS):
        adj = jgnn.EdgeListAdj(jnp.asarray(src[p]), jnp.asarray(dst[p]),
                               jnp.asarray(w[p]), N_ROWS, N_COLS)
        want, vjp = jax.vjp(adj.spmm, jnp.asarray(h[p]))
        _close(fwd[p * N_ROWS:(p + 1) * N_ROWS], want, f"forward {p}")
        _close(d_h[p * N_COLS:(p + 1) * N_COLS], vjp(jnp.asarray(g[p]))[0],
               f"d_h {p}")


def _jax_heads(src, dst, w, p):
    """The reference's loop over the heads, ``[n_rows, H, dh]``."""
    adj = jgnn.EdgeListAdj(jnp.asarray(src[p]), jnp.asarray(dst[p]),
                           jnp.asarray(w[p]), N_ROWS, N_COLS)

    def f(e, hh):
        return jnp.stack([adj.spmm_at(e[:, z], hh[:, z, :])
                          for z in range(e.shape[1])], axis=1)
    return f


def _pack_route(src, dst, w, long_row):
    packs = _packs(src, dst, w, long_row)
    return lambda e, h: ops.edge_spmm(h, packs, e)


def _coo_route(src, dst, w, long_row):
    adj = tgnn.EdgeListAdj(*(torch.from_numpy(a) for a in (src, dst, w)),
                           N_ROWS, N_COLS)
    return adj.spmm_at


@pytest.mark.parametrize("heads", [1, H])
@pytest.mark.parametrize("long_row", [16, ops.LONG_ROW])
@pytest.mark.parametrize("route", [_pack_route, _coo_route],
                         ids=["packs", "coo"])
def test_heads_spmm_at_is_jax_vjp_of_head_loop(route, long_row, heads):
    """``spmm_at`` of ``e_vals [P, m, H]`` and ``h [P, n, H, dh]`` (H = 1
    too, GAT's ``num_heads=1``): the output, ``d_h`` and ``d_vals [P, m,
    H]`` (0 at padding edges) against ``jax.vjp`` of the reference's head
    loop, partition by partition."""
    src, dst, w, h, g, e_vals = _edges(2)
    h, g = h[:, :, :heads].copy(), g[:, :, :heads].copy()
    e_vals = e_vals[..., :heads].copy()
    et = torch.from_numpy(e_vals).requires_grad_(True)
    ht = torch.from_numpy(h).requires_grad_(True)
    out = route(src, dst, w, long_row)(et, ht)
    assert out.shape == (N_PARTS, N_ROWS, heads, DH)
    d_e, d_h = torch.autograd.grad(out, [et, ht], torch.from_numpy(g))
    assert d_e.shape == e_vals.shape
    for p in range(N_PARTS):
        want, vjp = jax.vjp(_jax_heads(src, dst, w, p),
                            jnp.asarray(e_vals[p]), jnp.asarray(h[p]))
        je, jh = vjp(jnp.asarray(g[p]))
        _close(out[p], want, f"forward {p}")
        _close(d_e[p], je, f"d_vals {p}")
        _close(d_h[p], jh, f"d_h {p}")
    assert not d_e[torch.from_numpy(dst == N_ROWS)].any()


def test_heads_form_is_each_head_of_the_single_form():
    """Each head of the one-call form equals the ``[m]`` form of that
    head's values over that head's columns, on one partition and a
    stack; ``value_heads`` tells the two forms apart; a heads count that
    does not fit ``h`` is refused."""
    src, dst, w, h, _, e_vals = _edges(3)
    packs = _packs(src, dst, w)
    assert ops.value_heads(torch.from_numpy(e_vals), M) == H
    assert ops.value_heads(torch.from_numpy(e_vals[..., 0]), M) == 0
    got = ops.edge_spmm(torch.from_numpy(h), packs, torch.from_numpy(e_vals))
    for z in range(H):
        one = ops.edge_spmm(torch.from_numpy(h[:, :, z].copy()), packs,
                            torch.from_numpy(e_vals[..., z].copy()))
        _close(got[:, :, z], one.numpy(), f"head {z}")
    single = ops.edge_packs(*(torch.from_numpy(a[0]) for a in (src, dst, w)),
                            N_ROWS, N_COLS)
    got0 = ops.edge_spmm(torch.from_numpy(h[0]), single,
                         torch.from_numpy(e_vals[0]))
    _close(got0, got[0].numpy(), "one partition")
    with pytest.raises(ValueError, match="do not fit"):
        ops.edge_spmm(torch.from_numpy(h[:, :, :2].copy()), packs,
                      torch.from_numpy(e_vals))


class _PackRouteAdj(tgnn.EdgeListAdj):
    """An edge list whose ``spmm_at`` takes the card's route (the packs
    through ``ops.edge_spmm``) on CPU tensors, counting its calls."""
    calls = 0

    def spmm_at(self, e_vals, h):
        type(self).calls += 1
        return ops.edge_spmm(h, self.packs, e_vals)


def _jgat_layer(cfg, jadj, h, g, p0):

    def loss(p_):
        out = jgnn._layer_apply(cfg, p_, jadj, jnp.asarray(h), jadj.n_rows,
                                False)
        return jnp.sum(out * g), out
    (_, out), grads = jax.value_and_grad(loss, has_aux=True)(p0)
    return np.asarray(out), grads


@pytest.mark.parametrize("heads", [1, H])
@pytest.mark.parametrize("route", ["packs", "coo"])
def test_gat_layer_one_call_matches_reference_where_finite(route, heads,
                                                           monkeypatch):
    """The port's GAT layer (its heads, 4 or 1, in one call) on each
    partition's edges trimmed to the live ones, where the JAX package's
    gradients are finite: output and parameter gradients within 1e-5 of
    the JAX layer's; over the packs one ``ops.edge_attention`` call a
    layer and no ``spmm_at``."""
    attention_calls = []
    edge_attention = ops.edge_attention
    monkeypatch.setattr(ops, "edge_attention", lambda *a: (
        attention_calls.append(1), edge_attention(*a))[1])
    rng = np.random.default_rng(9)
    src, dst, w, _, _, _ = _edges(4)
    jcfg = jgnn.GNNConfig(model="gat", in_dim=12, hidden_dim=16, out_dim=5,
                          num_layers=2, num_heads=heads)
    p0 = {k: np.asarray(v) for k, v in
          jgnn.init_gnn(jax.random.PRNGKey(3), jcfg)[0].items()}
    tcfg = tgnn.GNNConfig(model="gat", in_dim=12, hidden_dim=16, out_dim=5,
                          num_layers=2, num_heads=heads)
    assert p0["a_src"].shape[0] == tcfg.num_heads == heads
    for p in range(N_PARTS):
        keep = dst[p] < N_ROWS
        s_, d_, w_ = src[p][keep], dst[p][keep], w[p][keep]
        h = rng.normal(size=(N_COLS, 12)).astype(np.float32)
        g = rng.normal(size=(N_ROWS, 16)).astype(np.float32)
        jadj = jgnn.EdgeListAdj(jnp.asarray(s_), jnp.asarray(d_),
                                jnp.asarray(w_), N_ROWS, N_COLS)
        jout, jg = _jgat_layer(jcfg, jadj, h, g, jax.tree.map(jnp.asarray, p0))
        assert all(np.isfinite(np.asarray(v)).all() for v in jg.values())
        edges = [torch.from_numpy(a) for a in (s_.astype(np.int64),
                                               d_.astype(np.int64), w_)]
        if route == "packs":
            adj = _PackRouteAdj(*edges, N_ROWS, N_COLS,
                                packs=ops.edge_packs(*edges, N_ROWS,
                                                     N_COLS))
        else:
            adj = tgnn.EdgeListAdj(*edges, N_ROWS, N_COLS)
        params = {k: torch.from_numpy(v.copy()).requires_grad_(True)
                  for k, v in p0.items()}
        before, calls = _PackRouteAdj.calls, len(attention_calls)
        out = tgnn._layer_apply(tcfg, params, adj, torch.from_numpy(h),
                                N_ROWS, False)
        (out * torch.from_numpy(g)).sum().backward()
        if route == "packs":
            assert len(attention_calls) - calls == 1
            assert _PackRouteAdj.calls == before
        _close(out, jout, f"partition {p} output")
        for k, v in params.items():
            _close(v.grad, jg[k], f"partition {p} d{k}")


def _event(name, device_type, annotation=False, ms=1.0, activity=None):
    ev = types.SimpleNamespace(name=name, device_type=device_type,
                               is_user_annotation=annotation,
                               device_time_total=ms * 1e3)
    if activity is not None:
        ev.activity_type = activity
    return ev


class _FakeProf:
    """A profile with one range enclosing two kernels, a copy, a memset,
    and host events."""

    def __init__(self, with_activity: bool):
        cuda = torch.autograd.DeviceType.CUDA
        cpu = torch.autograd.DeviceType.CPU
        act = (lambda a: a) if with_activity else (lambda a: None)
        self.evs = [
            _event("layer0/spmm", cuda, True, 3.0, act("gpu_user_annotation")),
            _event("csr_spmm_kernel", cuda, ms=1.0, activity=act("kernel")),
            _event("csr_spmm_kernel", cuda, ms=0.5, activity=act("kernel")),
            _event("Memcpy HtoD (Pageable -> Device)", cuda, ms=0.25,
                   activity=act("gpu_memcpy")),
            _event("Memset (Device)", cuda, ms=0.125,
                   activity=act("gpu_memset")),
            _event("aten::mm", cpu, ms=0.0)]
        self.avgs = [types.SimpleNamespace(key="aten::mm", device_type=cpu,
                                           self_cpu_time_total=2e3, count=1)]

    def events(self):
        return self.evs

    def key_averages(self):
        return self.avgs


@pytest.mark.parametrize("with_activity", [True, False])
def test_profiler_busy_sums_kernels_copies_and_memsets(with_activity):
    """``device_busy_ms`` is the kernels', copies' and memsets' device time
    (1.875 ms), not the range's 3 ms on top of them; the range is listed
    apart; the idle share of a 4 ms window is 1 - 1.875 / 4."""
    rec = profile_serve._summary("w", _FakeProf(with_activity), 4e-3)
    assert rec["device_busy_ms"] == pytest.approx(1.875)
    assert rec["idle_share"] == pytest.approx(1 - 1.875 / 4)
    assert [r["op"] for r in rec["device_ranges"]] == ["layer0/spmm"]
    top = {r["op"]: (r["ms"], r["calls"]) for r in rec["device_top"]}
    assert top["csr_spmm_kernel"] == (pytest.approx(1.5), 2)
    assert "layer0/spmm" not in top and len(top) == 3
    assert rec["host_top"][0]["op"] == "aten::mm"


@pytest.mark.parametrize("d,elem,mean,want", [
    (256, 4, 14.0, (4, 64, "ring")),     # the edge forward: 1 KB, the ring
    (256, 4, 0.6, (4, 64, "ring")),      # the gather VJP's transposed map
    (256, 4, 32.0, (4, 32, "regs4")),    # the 1.5D chunk: 2 x 512 B
    (500, 4, 5.5, (4, 16, "regs4")),     # the hybrid tail: 256 B stripes
    (64, 4, 14.0, (4, 16, "regs4")),     # a GAT head's 256 B row
    (7, 4, 14.0, (1, 16, "regs2")),      # narrow words, masked lanes
])
def test_csr_launch_config_by_row_width_and_length(d, elem, mean, want):
    """The CSR kernel's stripe and load mode, picked on the host from the
    row's bytes and the pack's mean entries a row
    (``csr_spmm.mean_row``); a sweep's explicit choice overrides them."""
    from repro_torch.kernels import csr_spmm
    vec, stripe, mode = csr_spmm.csr_launch_config(d, elem, 0, mean)
    assert (vec, stripe, mode) == (want[0], want[1],
                                   csr_spmm.MODES[want[2]])
    assert csr_spmm.csr_launch_config(d, elem, 0, mean, 256, "regs2")[2] \
        == csr_spmm.MODES["regs2"]
