"""The port's kernel ops on the CPU (their plain versions) against the JAX
package's Pallas kernels run in interpret mode, as its own tests run them.

ELL SpMM (unchunked and column-chunked), its backward and the hybrid SpMM
agree within 1e-5 (f32 sums in another order); the row gather is
bit-exact, for f32 and bf16, any width, and an empty index.
"""
import jax
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.cache_gather import gather_rows_pallas
from repro.kernels.ell_spmm import ell_spmm_pallas
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from torch_threads import torch_threads_per_worker  # noqa: F401

# tests/test_kernels.py's SHAPES (n_rows, max_deg, n_cols, d), plus ragged
# shapes that are no multiple of the Pallas blocks, among them the widths
# at which the CUDA kernel takes scalar (d = 499) and 8-byte (d = 130) loads
SHAPES = [
    (128, 4, 256, 128),
    (256, 9, 300, 128),
    (384, 16, 512, 256),
    (128, 1, 64, 128),
    (70, 5, 90, 48),
    (33, 37, 50, 7),
    (100, 6, 120, 499),
    (64, 9, 80, 130),
]
TOL = dict(rtol=1e-5, atol=1e-5)


def _rand_ell(rng, n_rows, max_deg, n_cols, d):
    cols = rng.integers(0, n_cols, size=(n_rows, max_deg)).astype(np.int32)
    vals = rng.normal(size=(n_rows, max_deg)).astype(np.float32)
    vals[rng.random((n_rows, max_deg)) < 0.3] = 0.0   # padding slots
    h = rng.normal(size=(n_cols, d)).astype(np.float32)
    return cols, vals, h


@pytest.mark.parametrize("n_rows,max_deg,n_cols,d", SHAPES)
def test_ell_spmm_matches_pallas(n_rows, max_deg, n_cols, d):
    rng = np.random.default_rng(n_rows + max_deg)
    cols, vals, h = _rand_ell(rng, n_rows, max_deg, n_cols, d)
    got = tops.ell_spmm(torch.from_numpy(cols), torch.from_numpy(vals),
                        torch.from_numpy(h))
    if n_rows % 128 == 0 and d % 128 == 0:
        want = ell_spmm_pallas(jnp.asarray(cols), jnp.asarray(vals),
                               jnp.asarray(h), interpret=True)
    else:  # the padding wrapper around the same pallas_call
        want = jops.ell_spmm(jnp.asarray(cols), jnp.asarray(vals),
                             jnp.asarray(h), interpret=True)
    assert got.shape == (n_rows, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ell_spmm_stacked_equals_per_partition():
    """One ``[P, ...]`` call == the Pallas kernel on each partition."""
    rng = np.random.default_rng(9)
    parts = [_rand_ell(rng, 70, 6, 90, 40) for _ in range(3)]
    cols = np.stack([c for c, _, _ in parts])
    vals = np.stack([v for _, v, _ in parts])
    h = np.stack([x for _, _, x in parts])
    got = tops.ell_spmm(torch.from_numpy(cols), torch.from_numpy(vals),
                        torch.from_numpy(h))
    assert got.shape == (3, 70, 40)
    for i in range(3):
        want = jops.ell_spmm(jnp.asarray(cols[i]), jnp.asarray(vals[i]),
                             jnp.asarray(h[i]), interpret=True)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n_rows,max_deg,n_cols,d,chunk", [
    (128, 4, 256, 128, 64), (128, 4, 256, 128, 128), (256, 9, 384, 128, 128),
    (70, 5, 128, 48, 64)])
def test_chunked_ell_spmm_matches_pallas_chunk_kernel(n_rows, max_deg, n_cols,
                                                      d, chunk):
    rng = np.random.default_rng(n_rows + chunk)
    cols, vals, h = _rand_ell(rng, n_rows, max_deg, n_cols, d)
    got = tops.ell_spmm(torch.from_numpy(cols), torch.from_numpy(vals),
                        torch.from_numpy(h), col_chunk=chunk)
    want = jops.ell_spmm(jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(h),
                         col_chunk=chunk, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        tref.ell_spmm_chunked_ref(torch.from_numpy(cols),
                                  torch.from_numpy(vals),
                                  torch.from_numpy(h), chunk).numpy(),
        np.asarray(want), **TOL)


def test_chunked_ell_spmm_needs_a_divisor():
    cols = torch.zeros((8, 2), dtype=torch.int32)
    vals = torch.ones((8, 2))
    h = torch.ones((100, 4))
    with pytest.raises(ValueError, match="multiple of col_chunk"):
        tops.ell_spmm(cols, vals, h, col_chunk=64)
    with pytest.raises(ValueError, match=">= 1"):
        tops.ell_spmm(cols, vals, h, col_chunk=0)
    # a chunk of at least n_cols rows is the unchunked product
    torch.testing.assert_close(tops.ell_spmm(cols, vals, h, col_chunk=100),
                               tops.ell_spmm(cols, vals, h))


@pytest.mark.parametrize("n_rows,max_deg,n_cols,d", SHAPES[:3] + SHAPES[4:])
def test_ell_spmm_backward_matches_jax_vjp(n_rows, max_deg, n_cols, d):
    """``ell_spmm_bwd_ref`` and the autograd Function's gradients against
    ``jax.vjp`` of the Pallas kernel's custom VJP (interpret mode)."""
    rng = np.random.default_rng(n_rows * max_deg + d)
    cols, vals, h = _rand_ell(rng, n_rows, max_deg, n_cols, d)
    g = rng.normal(size=(n_rows, d)).astype(np.float32)

    def fwd(v, x):
        if n_rows % 128 == 0 and d % 128 == 0:
            return ell_spmm_pallas(jnp.asarray(cols), v, x, interpret=True)
        return jops.ell_spmm(jnp.asarray(cols), v, x, interpret=True)
    _, pull = jax.vjp(fwd, jnp.asarray(vals), jnp.asarray(h))
    want_dv, want_dh = (np.asarray(a) for a in pull(jnp.asarray(g)))

    tc, tv, th, tg = (torch.from_numpy(a) for a in (cols, vals, h, g))
    dv, dh = tref.ell_spmm_bwd_ref(tc, tv, th, tg, n_cols)
    np.testing.assert_allclose(dv.numpy(), want_dv, **TOL)
    np.testing.assert_allclose(dh.numpy(), want_dh, **TOL)

    v = tv.clone().requires_grad_(True)
    x = th.clone().requires_grad_(True)
    out = tops.ell_spmm(tc, v, x)
    assert out.grad_fn is not None
    out.backward(tg)
    np.testing.assert_allclose(v.grad.numpy(), want_dv, **TOL)
    np.testing.assert_allclose(x.grad.numpy(), want_dh, **TOL)


def test_ell_spmm_backward_asks_only_for_what_is_needed():
    """With constant ``vals`` (every training step of the port) the
    backward computes ``d_h`` only; a stacked call's gradient is each
    partition's own."""
    rng = np.random.default_rng(12)
    parts = [_rand_ell(rng, 30, 4, 40, 8) for _ in range(2)]
    cols, vals, h = (torch.from_numpy(np.stack([p[i] for p in parts]))
                     for i in range(3))
    g = torch.from_numpy(rng.normal(size=(2, 30, 8)).astype(np.float32))
    dv, dh = tref.ell_spmm_bwd_ref(cols, vals, None, g, 40, need_vals=False)
    assert dv is None and dh.shape == (2, 40, 8)
    x = h.clone().requires_grad_(True)
    tops.ell_spmm(cols, vals, x).backward(g)
    np.testing.assert_allclose(x.grad.numpy(), dh.numpy(), **TOL)
    for i in range(2):
        _, want = tref.ell_spmm_bwd_ref(cols[i], vals[i], h[i], g[i], 40)
        np.testing.assert_allclose(dh[i].numpy(), want.numpy(), **TOL)


def test_ell_spmm_ref_keeps_bf16_dtype():
    rng = np.random.default_rng(4)
    cols, vals, h = _rand_ell(rng, 40, 5, 30, 16)
    hb = torch.from_numpy(h).to(torch.bfloat16)
    got = tref.ell_spmm_ref(torch.from_numpy(cols), torch.from_numpy(vals),
                            hb)
    assert got.dtype == torch.bfloat16
    want = tref.ell_spmm_ref(torch.from_numpy(cols), torch.from_numpy(vals),
                             hb.float())
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               rtol=1e-2, atol=1e-2)


def _hybrid_case(seed, n_rows=60, n_cols=100, m=900):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_cols, m).astype(np.int32)
    dst = (rng.zipf(1.5, m) % n_rows).astype(np.int32)
    w = rng.normal(size=m).astype(np.float32)
    h = rng.normal(size=(n_cols, 24)).astype(np.float32)
    return jops.ell_pack_hybrid(src, dst, w, n_rows, quantile=0.8), h


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hybrid_spmm_matches_pallas(seed):
    (cols, vals, ts, td, tw), h = _hybrid_case(seed)
    assert ts.size, "the case must have a COO tail"
    want = jops.hybrid_spmm(*(jnp.asarray(a) for a in
                              (cols, vals, ts, td, tw, h)), interpret=True)
    got = tops.hybrid_spmm(*(torch.from_numpy(a) for a in
                             (cols, vals, ts, td, tw, h)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_hybrid_spmm_stacked_drops_tail_padding():
    """Stacked tails padded with ``tail_dst == n_rows`` (the spare row)
    give each partition's own hybrid SpMM."""
    cases = [_hybrid_case(s) for s in (3, 4)]
    k = max(c[0].shape[1] for c, _ in cases)
    mt = max(c[2].shape[0] for c, _ in cases) + 5
    n_rows = cases[0][0][0].shape[0]
    cols = np.zeros((2, n_rows, k), np.int32)
    vals = np.zeros((2, n_rows, k), np.float32)
    ts = np.zeros((2, mt), np.int32)
    td = np.full((2, mt), n_rows, np.int32)
    tw = np.zeros((2, mt), np.float32)
    for i, ((c, v, s, d, w), _) in enumerate(cases):
        cols[i, :, : c.shape[1]], vals[i, :, : v.shape[1]] = c, v
        ts[i, : s.size], td[i, : d.size], tw[i, : w.size] = s, d, w
    h = np.stack([x for _, x in cases])
    got = tops.hybrid_spmm(*(torch.from_numpy(a) for a in
                             (cols, vals, ts, td, tw, h)))
    for i, ((c, v, s, d, w), x) in enumerate(cases):
        want = jops.hybrid_spmm(*(jnp.asarray(a) for a in (c, v, s, d, w, x)),
                                interpret=True)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), **TOL)


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_src,n_out,d", [(200, 64, 7), (300, 130, 128),
                                           (90, 17, 500)])
def test_gather_rows_bitexact(dtype, n_src, n_out, d):
    rng = np.random.default_rng(n_src + d)
    src32 = rng.normal(size=(n_src, d)).astype(np.float32)
    idx = rng.integers(0, n_src, n_out).astype(np.int32)
    src_j = jnp.asarray(src32, getattr(jnp, dtype))
    src_t = torch.from_numpy(src32).to(getattr(torch, dtype))
    if n_out % 128 == 0 and d % 128 == 0:
        want = gather_rows_pallas(src_j, jnp.asarray(idx), interpret=True)
    else:
        want = jops.gather_rows(src_j, jnp.asarray(idx), interpret=True)
    got = tops.gather_rows(src_t, torch.from_numpy(idx))
    assert got.dtype == src_t.dtype and got.shape == (n_out, d)
    want_bits = _bits(np.asarray(want))
    got_bits = _bits(got.view(torch.int16 if dtype == "bfloat16"
                              else torch.int32).numpy())
    np.testing.assert_array_equal(got_bits, want_bits)


def test_gather_rows_empty_index():
    src = torch.randn(10, 7)
    got = tops.gather_rows(src, torch.zeros(0, dtype=torch.int32))
    want = jops.gather_rows(jnp.asarray(src.numpy()),
                            jnp.zeros(0, jnp.int32), interpret=True)
    assert got.shape == tuple(want.shape) == (0, 7)
    assert got.dtype == torch.float32


def test_coo_spmm_drops_padding_edges():
    """``dst == n_rows`` edges land in the spare row and vanish, as the
    reference's segment sum drops them."""
    rng = np.random.default_rng(8)
    src = rng.integers(0, 30, 200)
    dst = rng.integers(0, 21, 200)            # 20 rows; 20 is padding
    w = rng.normal(size=200).astype(np.float32)
    h = rng.normal(size=(30, 5)).astype(np.float32)
    got = tops.coo_spmm(torch.from_numpy(src), torch.from_numpy(dst),
                        torch.from_numpy(w), torch.from_numpy(h), 20)
    keep = dst < 20
    want = np.zeros((20, 5), np.float32)
    np.add.at(want, dst[keep], w[keep, None] * h[src[keep]])
    np.testing.assert_allclose(got.numpy(), want, **TOL)
