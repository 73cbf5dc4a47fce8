"""The port's differentiable row gather on the CPU against the JAX package.

- ``ops.pack_rows`` forward equals the JAX package's ``pack_rows``, with
  the Pallas kernel in interpret mode and with the ``jnp.take`` route, bit
  for bit, for ``[n]`` and ``[P, B]`` indices, repeated ids and empty
  indices, f32 and bf16;
- its backward (the CSR product over the transposed index map,
  ``ops.gather_pack``) matches ``jax.vjp`` of the ``jnp.take`` route within
  1e-6.  (``jax.grad`` through the Pallas route does not linearise, so the
  ``jnp.take`` route is the reference gradient.);
- ``gather_pack`` has no entry for an id outside ``[0, n_src)``;
- the out-of-range contract: such an id reads a zero row in the gather
  and adds nothing in the ELL products, and a NaN in the source stays out
  of it; the JAX package wraps a negative id and gives NaN past the end;
- ``ops.gather_rows`` keeps the autograd graph when ``src`` requires a
  gradient and takes the raw path under ``inference_mode`` and ``no_grad``;
  it refuses a pack of another shape than ``[n_src, idx.numel()]``;
- the sim runtime's tier pulls: the composed one-gather pull and the
  two-stage wire pull give the rows of the JAX package's two-stage
  indexing bit for bit, and its gradients within 1e-6 (on a bf16 wire
  within 2^-6 of the largest: the payload's gradient rounds to bf16);
  a pull whose halo dtype is not the one its maps were built for raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.dist import capgnn_sim as tsim
from repro_torch.dist.exchange import ExchangeTier, GlobalTier
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

GRAD_TOL = dict(rtol=1e-6, atol=1e-6)

# (n_src, idx shape, id range): repeated ids throughout (ids drawn with
# replacement from fewer rows than the index holds)
CASES = {
    "flat": (40, (100,), 40),
    "flat_few_rows": (5, (64,), 5),
    "peer_blocks": (60, (4, 33), 60),
    "peer_blocks_128": (300, (2, 128), 300),
    "empty": (10, (0,), 10),
    "empty_blocks": (10, (4, 0), 10),
}


def _case(name, d=24, dtype="float32"):
    n_src, shape, hi = CASES[name]
    rng = np.random.default_rng(len(name) * 7 + d)
    src = rng.normal(size=(n_src, d)).astype(np.float32)
    idx = rng.integers(0, hi, size=shape).astype(np.int32)
    g = rng.normal(size=shape + (d,)).astype(np.float32)
    src_j = jnp.asarray(src, getattr(jnp, dtype))
    src_t = torch.from_numpy(src).to(getattr(torch, dtype))
    return src_j, src_t, idx, g


def _bits(t: torch.Tensor) -> np.ndarray:
    word = torch.int16 if t.element_size() == 2 else torch.int32
    return t.contiguous().view(word).numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32).astype(
        np.int16 if a.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
def test_pack_rows_forward_matches_jax(name, dtype):
    src_j, src_t, idx, _ = _case(name, dtype=dtype)
    got = tops.pack_rows(src_t, torch.from_numpy(idx))
    assert got.shape == idx.shape + (src_t.shape[1],)
    assert got.dtype == src_t.dtype
    for use_pallas in (True, False):
        want = jops.pack_rows(src_j, jnp.asarray(idx), use_pallas=use_pallas,
                              interpret=True)
        assert tuple(want.shape) == tuple(got.shape)
        np.testing.assert_array_equal(_bits(got), _jbits(want))


@pytest.mark.parametrize("with_pack", [False, True])
@pytest.mark.parametrize("name", [n for n in CASES if "empty" not in n])
def test_pack_rows_backward_matches_jax_vjp(name, with_pack):
    """``d_src`` of the port's gather (its pack given, or built for the
    call and counted) against ``jax.vjp`` of the ``jnp.take`` route."""
    src_j, src_t, idx, g = _case(name)
    _, pull = jax.vjp(lambda s: jops.pack_rows(s, jnp.asarray(idx),
                                               use_pallas=False), src_j)
    (want,) = pull(jnp.asarray(g))
    pack = tops.gather_pack(idx, src_t.shape[0]) if with_pack else None
    builds = tops.pack_for_call.builds
    x = src_t.clone().requires_grad_(True)
    out = tops.pack_rows(x, torch.from_numpy(idx), pack)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    assert tops.pack_for_call.builds == builds + (not with_pack)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), **GRAD_TOL)


def test_gather_pack_leaves_out_of_range_ids_out():
    n_src = 7
    idx = np.array([3, -1, 6, 7, 3, -9, 12, 0, 3], np.int32)
    pack = tops.gather_pack(idx, n_src)
    valid = (idx >= 0) & (idx < n_src)
    assert pack.nnz == int(valid.sum()) == 5
    assert (pack.n_rows, pack.n_cols, pack.every_row) == (n_src, idx.size,
                                                          True)
    rows = np.repeat(np.arange(n_src), np.diff(pack.rowptr.numpy()))
    np.testing.assert_array_equal(rows, np.sort(idx[valid]))
    # each row's entries are the positions naming it, in order
    np.testing.assert_array_equal(pack.col.numpy(), [7, 0, 4, 8, 2])
    assert (pack.w.numpy() == 1).all()
    # an index with no id in range: no entry, every row still listed
    empty = tops.gather_pack(np.array([-1, n_src]), n_src)
    assert empty.nnz == 0 and empty.short_rows.numel() == n_src


def test_gather_out_of_range_reads_zero_rows_and_keeps_nan_out():
    """An id outside ``[0, n_src)`` reads a zero row on the CPU, as the
    card's kernel does, even when the row it would clamp or wrap to holds
    NaN; the JAX package's ``jnp.take`` (and its Pallas kernel) wraps a
    negative id and gives a NaN row past the end."""
    src = np.arange(12, dtype=np.float32).reshape(4, 3)
    src[0] = src[3] = np.nan
    idx = np.array([-1, 4, 1, -4, 9], np.int32)
    got = tops.gather_rows(torch.from_numpy(src), torch.from_numpy(idx))
    want = np.zeros((5, 3), np.float32)
    want[2] = src[1]
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.signbit(got.numpy()[[0, 1, 3, 4]]).any()
    x = torch.from_numpy(src).requires_grad_(True)
    tops.gather_rows(x, torch.from_numpy(idx)).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), [[0] * 3, [1] * 3, [0] * 3,
                                                   [0] * 3])
    # the JAX package differs at those ids
    clean = np.arange(12, dtype=np.float32).reshape(4, 3)
    for use_pallas in (True, False):
        jx = np.asarray(jops.pack_rows(jnp.asarray(clean), jnp.asarray(idx),
                                       use_pallas=use_pallas))
        np.testing.assert_array_equal(jx[0], clean[3])     # -1 wraps
        assert np.isnan(jx[1]).all()                       # past the end
    # an empty source: every id is out of range
    none = tref.gather_rows_ref(torch.zeros((0, 3)), torch.tensor([0, -1]))
    np.testing.assert_array_equal(none.numpy(), np.zeros((2, 3)))


def test_ell_out_of_range_columns_add_nothing():
    """An ELL slot whose column lies outside ``[0, n_cols)`` adds nothing
    to the product (unchunked and chunked), and has ``d_vals`` 0 and no
    ``d_h`` share, with NaN in the h rows a clamp would reach."""
    rng = np.random.default_rng(3)
    n_rows, k, n_cols, d = 6, 4, 8, 5
    cols = rng.integers(1, n_cols - 1, (n_rows, k)).astype(np.int32)
    vals = rng.normal(size=(n_rows, k)).astype(np.float32)
    h = rng.normal(size=(n_cols, d)).astype(np.float32)
    g = rng.normal(size=(n_rows, d)).astype(np.float32)
    bad = cols.copy()
    bad[0, 1], bad[2, 3], bad[4, 0] = -1, n_cols, -n_cols
    h_nan = h.copy()
    h_nan[0] = h_nan[-1] = np.nan
    keep = (bad >= 0) & (bad < n_cols)
    t = torch.from_numpy
    want = tref.ell_spmm_ref(t(cols), t(np.where(keep, vals, 0)), t(h))
    got = tref.ell_spmm_ref(t(bad), t(vals), t(h_nan))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    chunked = tref.ell_spmm_chunked_ref(t(bad), t(vals), t(h_nan), 4)
    np.testing.assert_allclose(chunked.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    dv, dh = tref.ell_spmm_bwd_ref(t(bad), t(vals), t(h_nan), t(g), n_cols)
    assert (dv.numpy()[~keep] == 0).all()
    wdv, wdh = tref.ell_spmm_bwd_ref(t(cols), t(np.where(keep, vals, 0)),
                                     t(h), t(g), n_cols)
    np.testing.assert_array_equal(dv.numpy()[keep], wdv.numpy()[keep])
    np.testing.assert_array_equal(dh.numpy(), wdh.numpy())


def test_gather_rows_keeps_the_graph_only_while_autograd_records():
    """Beside ``tests/test_torch_kernels.py``'s ``grad_fn`` check of the
    ELL product: the gather has a ``grad_fn`` when ``src`` requires a
    gradient, and none under ``inference_mode``, ``no_grad`` or for a
    ``src`` that needs none, where it is the raw call."""
    src = torch.randn(20, 6, requires_grad=True)
    idx = torch.tensor([3, 19, 3, 0])
    out = tops.gather_rows(src, idx)
    assert isinstance(out.grad_fn, tops.GatherRowsFn._backward_cls)
    builds = tops.pack_for_call.builds
    with torch.inference_mode():
        raw = tops.gather_rows(src, idx)
    assert raw.grad_fn is None and raw.is_inference()
    with torch.no_grad():
        assert tops.gather_rows(src, idx).grad_fn is None
    assert tops.gather_rows(src.detach(), idx).grad_fn is None
    assert tops.pack_for_call.builds == builds
    torch.testing.assert_close(raw, out.detach(), rtol=0, atol=0)


@pytest.mark.parametrize("shape", ["rows", "ids"])
def test_gather_refuses_a_pack_of_another_shape(shape):
    """A pack built for another source or index raises before the
    forward, instead of giving a wrong gradient."""
    src = torch.randn(20, 6, requires_grad=True)
    idx = torch.tensor([3, 19, 3, 0])
    pack = (tops.gather_pack(idx, 21) if shape == "rows"
            else tops.gather_pack(idx[:3], 20))
    with pytest.raises(ValueError, match="does not fit"):
        tops.gather_rows(src, idx, pack)
    out = tops.gather_rows(src, idx, tops.gather_pack(idx, 20))
    assert isinstance(out.grad_fn, tops.GatherRowsFn._backward_cls)


def _tier(rng, n_parts, n_inner, n_send, n_recv):
    """A random exchange tier: owners' deduplicated send rows (padding
    slots name row 0), consumers addressing them (several consumers per
    payload row), some invalid receive rows."""
    send_row = np.stack([rng.permutation(n_inner)[:n_send]
                         for _ in range(n_parts)]).astype(np.int32)
    send_valid = np.ones((n_parts, n_send), bool)
    send_valid[:, -2:] = False
    send_row[~send_valid] = 0
    part = rng.integers(0, n_parts, (n_parts, n_recv)).astype(np.int32)
    slot = rng.integers(0, n_send - 2, (n_parts, n_recv)).astype(np.int32)
    valid = rng.random((n_parts, n_recv)) < 0.8
    part[~valid], slot[~valid] = 0, 0
    z = np.zeros((n_parts, n_recv), np.int32)
    peer = np.zeros((n_parts, n_parts, 1), np.int32)
    tier = ExchangeTier("local", send_row, send_valid, part, slot, z, valid,
                        peer, peer.astype(bool), z)
    glob = GlobalTier(send_row, send_valid, part[0], slot[0], z, part,
                      valid, valid[0])
    return tier, glob


def _two_stage(h, send_row, part, slot, valid, wire):
    """The JAX package's two-stage pull in torch indexing: the owners'
    payload, cast to the wire dtype, addressed by the consumers."""
    pidx = torch.arange(h.shape[0])[:, None]
    payload = h[pidx, torch.from_numpy(send_row).long()]
    if wire is not None:
        payload = payload.to(wire)
    rows = payload[torch.from_numpy(part).long(),
                   torch.from_numpy(slot).long()].to(h.dtype)
    v = torch.from_numpy(valid)
    return torch.where(v[..., None], rows, 0.0)


@pytest.mark.parametrize("wire", [None, torch.bfloat16])
def test_sim_tier_pulls_equal_the_two_stage_pull(wire):
    """The sim's pull and global fill (one composed gather, or the two
    stages on a bf16 wire) give the two-stage rows bit for bit and their
    gradients within 1e-6; the buffer's reads too."""
    rng = np.random.default_rng(5)
    n_parts, n_inner, d = 3, 30, 8
    tier, glob = _tier(rng, n_parts, n_inner, 12, 40)
    xa = {"loc": tsim._tier_dict(tier, n_inner, halo_dtype=wire),
          "gl": tsim._glob_dict(glob, n_inner, halo_dtype=wire)}
    assert set(xa["loc"]["pull"]) == ({"wire", "send", "addr"} if wire
                                      else {"wire", "pull"})
    h0 = torch.from_numpy(rng.normal(size=(n_parts, n_inner, d)).astype(
        np.float32))
    builds = tops.pack_for_call.builds
    for name, fn, args in (
            ("pull", tsim._pull, (tier.recv_src_part, tier.recv_src_slot,
                                  tier.recv_valid)),
            ("fill", tsim._build_global, (glob.src_part, glob.src_slot,
                                          glob.buf_valid))):
        td = xa["loc"] if name == "pull" else xa["gl"]
        h = h0.clone().requires_grad_(True)
        got = fn(td, h, wire)
        hw = h0.clone().requires_grad_(True)
        want = _two_stage(hw, tier.send_row, *args, wire)
        np.testing.assert_array_equal(_bits(got.detach()),
                                      _bits(want.detach()))
        g = torch.randn(got.shape, generator=torch.Generator().manual_seed(1))
        got.backward(g)
        want.backward(g)
        # on a bf16 wire the payload's gradient rounds to bf16: the two
        # stages' indexing adds in bf16, a rounding per add, the CSR
        # kernel sums in f32 and rounds once
        tol = GRAD_TOL if wire is None else dict(
            rtol=0, atol=2 ** -6 * float(hw.grad.abs().max()))
        np.testing.assert_allclose(h.grad.numpy(), hw.grad.numpy(), **tol)
    # the reads of a buffer that needs a gradient (a refresh step)
    buf = torch.randn(glob.buf_size, d, requires_grad=True)
    halo = torch.zeros(n_parts, 7, d)
    got = tsim._gather(xa["gl"]["read"], buf)
    ok = torch.from_numpy(glob.read_valid)[..., None]
    want_rows = buf[torch.from_numpy(glob.read_buf_idx).long()]
    torch.testing.assert_close(got, torch.where(ok, want_rows, 0.0),
                               rtol=0, atol=0)
    assert tsim._read_global(xa["gl"], buf, halo).shape == halo.shape
    assert tops.pack_for_call.builds == builds


@pytest.mark.parametrize("built, pulled", [(None, torch.bfloat16),
                                           (torch.bfloat16, None)])
def test_sim_pull_refuses_another_wire_dtype(built, pulled):
    """The maps record the payload dtype they were built for; a pull
    (or a global fill) with another one raises instead of skipping or
    adding the cast."""
    rng = np.random.default_rng(6)
    n_parts, n_inner = 3, 30
    tier, glob = _tier(rng, n_parts, n_inner, 12, 40)
    td = tsim._tier_dict(tier, n_inner, halo_dtype=built)
    gd = tsim._glob_dict(glob, n_inner, halo_dtype=built)
    assert td["pull"]["wire"] == gd["fill"]["wire"] == built
    h = torch.randn(n_parts, n_inner, 4)
    with pytest.raises(ValueError, match="halo dtype"):
        tsim._pull(td, h, pulled)
    with pytest.raises(ValueError, match="halo dtype"):
        tsim._build_global(gd, h, pulled)
    assert tsim._pull(td, h, built).shape == (n_parts, 40, 4)
