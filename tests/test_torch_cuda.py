"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: the kernels have no CPU mode, so these tests need an
NVIDIA GPU with ``nvcc`` and skip without one.  On a GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

ELL SpMM, its chunked variant, its ``d_vals`` kernel and the CSR kernel
(``d_h`` and the hybrid tail) agree with the plain versions within atol
1e-4 / rtol 1e-5 (f32 sums in another order, fixed from run to run: two
``d_h`` launches give the same bits); bf16 within one bf16 rounding of
the output (rtol/atol 1e-2); the row gather is bit-exact.  The ELL
forward is held at every vector width (16-, 8-, 4- and 2-byte loads),
every stripe it is built for, with and without ``row_end``, and on ragged
packs; the CSR kernel on short rows only, long rows only and both, in
both modes, f32 and bf16, at unaligned base addresses; the ``d_vals``
kernel at ragged shapes, every stripe and lanes-per-slot, with live
column-0 slots (one value per row, the same bits at each) and two
launches bit-equal.  The row gather's backward (the CSR kernel over the
transposed index map) is bit-reproducible and within the CSR tolerance of
the CPU's; one refresh step of the training slice per backend (``hybrid``,
``ell``, ``edges``) matches the CPU within the train slice's tolerances.
"""
import numpy as np
import pytest
import torch

import dataclasses

from repro_torch.kernels import cache_gather, csr_spmm, ell_spmm, ops, ref

pytestmark = pytest.mark.cuda

ELL_TOL = dict(atol=1e-4, rtol=1e-5)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ell(seed, p, n, k, nc, d, pad=0.9):
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, nc, (p, n, k)).astype(np.int32)
    vals = rng.normal(size=(p, n, k)).astype(np.float32)
    vals[rng.random((p, n, k)) < pad] = 0.0
    h = rng.normal(size=(p, nc, d)).astype(np.float32)
    return [torch.from_numpy(a) for a in (cols, vals, h)]


def _row_end(vals):
    return torch.from_numpy(ops.ell_row_end(vals.cpu().numpy())).to(
        vals.device)


def _ell_tol(dtype):
    return ELL_TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)


def _csr_tol(want):
    """f32: within 1e-5 of the largest magnitude (rows of up to 3,000
    entries summed in another order); bf16: one bf16 rounding."""
    if want.dtype == torch.float32:
        return dict(rtol=0.0, atol=1e-5 * float(want.abs().max()))
    return dict(rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [4, 7, 128, 130, 256, 499, 500, 700])
def test_ell_spmm_every_width(card, d, dtype):
    """16-byte loads (f32 at d % 4 == 0, bf16 at d % 8 == 0), 8-byte
    (bf16 at d = 500, f32 at d = 130), 4- and 2-byte scalar edges (d = 7,
    499), one stripe or several (d = 700), with and without row_end."""
    cols, vals, h = (t.to(card) for t in _ell(d, 2, 77, 40, 150, d))
    h = h.to(dtype)
    want = ref.ell_spmm_ref(cols, vals, h)
    for row_end in (None, _row_end(vals)):
        got = ell_spmm.ell_spmm(cols, vals, h, row_end)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == (2, 77, d)
        torch.testing.assert_close(got.float(), want.float(),
                                   **_ell_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ell_spmm_ragged_packs(card, dtype):
    """Row counts that fill no block of 4 rows, a block with no live slot,
    a live slot after 37 padding slots of its row, and columns outside
    [0, n_cols), which contribute nothing."""
    rng = np.random.default_rng(3)
    for n in (1, 3, 5, 13):
        cols, vals, h = (t.to(card) for t in _ell(n, 2, n, 50, 60, 256))
        h = h.to(dtype)
        torch.testing.assert_close(
            ell_spmm.ell_spmm(cols, vals, h, _row_end(vals)).float(),
            ref.ell_spmm_ref(cols, vals, h).float(), **_ell_tol(dtype))
    n, k, nc, d = 16, 70, 40, 500
    cols = torch.from_numpy(rng.integers(0, nc, (1, n, k)).astype(np.int32))
    vals = torch.zeros((1, n, k))
    vals[0, 8:, :3] = 1.5          # rows 0-7: two blocks with no live slot
    vals[0, 9, 37] = -2.0          # a live slot after padding in its row
    vals[0, 10, 69] = 0.5          # the last slot of a row
    bad = vals.clone()
    bad[0, 11, 5], cols[0, 11, 5] = 3.0, -1        # out of range below
    bad[0, 12, 6], cols[0, 12, 6] = 3.0, nc + 7    # and above
    h = torch.from_numpy(rng.normal(size=(1, nc, d)).astype(np.float32))
    want = ref.ell_spmm_ref(cols.clamp(0, nc - 1), vals, h.to(dtype))
    cols, bad, h = cols.to(card), bad.to(card), h.to(card, dtype)
    for row_end in (None, _row_end(bad)):
        got = ell_spmm.ell_spmm(cols, bad, h, row_end)
        torch.cuda.synchronize()
        assert not got[0, :8].any()
        torch.testing.assert_close(got.float().cpu(), want.float(),
                                   **_ell_tol(dtype))


@pytest.mark.parametrize("stripe", [16, 32, 64, 128])
def test_ell_spmm_every_launch_config(card, stripe, monkeypatch):
    """Every stripe the kernel is built for, at the widest vector a width
    allows, in f32 and bf16 (the stripes that ``chip_smoke.py --sweep``
    times), through the wrapper with ``STRIPE_BYTES`` set to that stripe;
    a row too narrow for it takes the stripe ``ell_launch_config`` caps it
    at."""
    cols, vals, h = (t.to(card) for t in _ell(stripe, 2, 90, 60, 200, 500))
    row_end = _row_end(vals)
    for dtype, d in ((torch.float32, 500), (torch.bfloat16, 500),
                     (torch.float32, 130), (torch.bfloat16, 256)):
        x = h[..., :d].contiguous().to(dtype)
        vec = ell_spmm.ell_launch_config(d, x.element_size(), 0)[0]
        monkeypatch.setattr(ell_spmm, "STRIPE_BYTES",
                            stripe * vec * x.element_size())
        _, used = ell_spmm.ell_launch_config(d, x.element_size(), 0)
        assert used == stripe or stripe // 2 >= d // vec
        got = ell_spmm.ell_spmm(cols, vals, x, row_end)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(),
                                   ref.ell_spmm_ref(cols, vals, x).float(),
                                   **_ell_tol(dtype))


@pytest.mark.parametrize("p,n,k,nc,d", [
    (1, 70, 5, 90, 48), (3, 33, 37, 50, 7), (2, 300, 144, 500, 500),
    (2, 100, 20, 300, 700), (4, 129, 1, 64, 256), (1, 31, 33, 40, 1)])
def test_ell_spmm_kernel_matches_plain(card, p, n, k, nc, d):
    cols, vals, h = (t.to(card) for t in _ell(p * n + d, p, n, k, nc, d))
    before = ell_spmm.ell_spmm.launches
    got = ops.ell_spmm(cols, vals, h)
    want = ref.ell_spmm_ref(cols, vals, h)
    torch.cuda.synchronize()
    assert ell_spmm.ell_spmm.launches == before + 1
    assert got.shape == (p, n, d) and got.device.type == "cuda"
    torch.testing.assert_close(got, want, **ELL_TOL)
    # one partition, unstacked 2-D operands
    torch.testing.assert_close(ops.ell_spmm(cols[-1], vals[-1], h[-1]),
                               want[-1], **ELL_TOL)


def test_ell_spmm_bf16_matches_plain(card):
    """bf16 h, f32 sums, bf16 output, as the TPU kernel."""
    cols, vals, h = (t.to(card) for t in _ell(11, 2, 300, 40, 500, 500))
    hb = h.to(torch.bfloat16)
    got = ops.ell_spmm(cols, vals, hb)
    want = ref.ell_spmm_ref(cols, vals, hb)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and want.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.parametrize("p,n,k,nc,d,chunk", [
    (2, 300, 40, 512, 256, 64), (1, 70, 5, 96, 48, 32),
    (3, 33, 37, 50, 7, 10), (2, 100, 20, 300, 700, 100)])
def test_chunked_kernel_matches_unchunked(card, p, n, k, nc, d, chunk):
    cols, vals, h = (t.to(card) for t in _ell(p + n + d, p, n, k, nc, d))
    before = ell_spmm.ell_spmm_chunked.launches
    got = ops.ell_spmm(cols, vals, h, col_chunk=chunk)
    torch.cuda.synchronize()
    assert ell_spmm.ell_spmm_chunked.launches == before + 1
    torch.testing.assert_close(got, ops.ell_spmm(cols, vals, h), **ELL_TOL)
    torch.testing.assert_close(
        got, ref.ell_spmm_chunked_ref(cols, vals, h, chunk), **ELL_TOL)
    torch.testing.assert_close(
        ops.ell_spmm(cols, vals, h, col_chunk=chunk, row_end=_row_end(vals)),
        got, **ELL_TOL)
    with pytest.raises(ValueError, match="multiple of col_chunk"):
        ops.ell_spmm(cols, vals, h, col_chunk=nc - 1)


@pytest.mark.parametrize("p,n,k,nc,d", [
    (1, 70, 5, 90, 48), (3, 33, 37, 50, 7), (2, 300, 144, 500, 500),
    (2, 100, 20, 300, 700), (4, 129, 1, 64, 256), (1, 31, 33, 40, 1)])
def test_backward_kernels_match_plain(card, p, n, k, nc, d):
    cols, vals, h = (t.to(card) for t in _ell(p * n + d + 1, p, n, k, nc, d))
    g = torch.randn((p, n, d), generator=torch.Generator(device=card)
                    .manual_seed(d), device=card)
    b_dh, b_dv = csr_spmm.csr_spmm.launches, ell_spmm.ell_spmm_dvals.launches
    pack = ops.transpose_csr(cols, vals, nc, long_row=16, device=card)
    dh = csr_spmm.csr_spmm(pack, g.view(-1, d)).view(p, nc, d)
    dv = ell_spmm.ell_spmm_dvals(cols, g, h)
    want_dv, want_dh = ref.ell_spmm_bwd_ref(cols, vals, h, g, nc)
    torch.cuda.synchronize()
    assert csr_spmm.csr_spmm.launches == b_dh + 1
    assert ell_spmm.ell_spmm_dvals.launches == b_dv + 1
    torch.testing.assert_close(dh, want_dh, **ELL_TOL)
    torch.testing.assert_close(dv, want_dv, **ELL_TOL)
    # one partition, unstacked 2-D operands
    pack0 = ops.transpose_csr(cols[0], vals[0], nc, device=card)
    torch.testing.assert_close(csr_spmm.csr_spmm(pack0, g[0]), want_dh[0],
                               **ELL_TOL)
    torch.testing.assert_close(ell_spmm.ell_spmm_dvals(cols[0], g[0], h[0]),
                               want_dv[0], **ELL_TOL)


@pytest.mark.parametrize("need_vals", [False, True])
def test_autograd_function_on_card_matches_cpu(card, need_vals):
    """The Function's gradients on the card equal the CPU's (the plain
    backward); ``d_vals`` launches only when ``vals`` needs a gradient."""
    cols, vals, h = _ell(5, 2, 90, 12, 120, 64, pad=0.5)
    g = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 90, 64)).astype(np.float32))
    grads = {}
    for dev in ("cpu", card):
        v = vals.to(dev).detach().requires_grad_(need_vals)
        x = h.to(dev).detach().requires_grad_(True)
        out = ops.ell_spmm(cols.to(dev), v, x)
        assert out.grad_fn is not None
        b_dv = ell_spmm.ell_spmm_dvals.launches
        out.backward(g.to(dev))
        if dev == card:
            torch.cuda.synchronize()
            assert ell_spmm.ell_spmm_dvals.launches == b_dv + int(need_vals)
        grads[str(dev)] = (x.grad.cpu(), v.grad.cpu() if need_vals else None)
    (gx_c, gv_c), (gx_g, gv_g) = grads["cpu"], grads[str(card)]
    torch.testing.assert_close(gx_g, gx_c, **ELL_TOL)
    if need_vals:
        torch.testing.assert_close(gv_g, gv_c, **ELL_TOL)


def test_hybrid_spmm_on_card_matches_cpu(card):
    cols, vals, h = _ell(3, 2, 60, 6, 80, 24)
    rng = np.random.default_rng(4)
    ts = torch.from_numpy(rng.integers(0, 80, (2, 50)))
    td = torch.from_numpy(rng.integers(0, 61, (2, 50)))   # 60 = padding
    tw = torch.from_numpy(rng.normal(size=(2, 50)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, 60, 24)).astype(np.float32))
    res = {}
    for dev in ("cpu", card):
        x = h.to(dev).detach().requires_grad_(True)
        out = ops.hybrid_spmm(*(t.to(dev) for t in (cols, vals, ts, td, tw)),
                              x)
        out.backward(g.to(dev))
        res[str(dev)] = (out.detach().cpu(), x.grad.cpu())
    for got, want in zip(res[str(card)], res["cpu"]):
        torch.testing.assert_close(got, want, **ELL_TOL)


def _csr_case(classes, every_row, seed=0):
    """A CSR pack whose listed rows are all short, all long, or both (the
    threshold is 8 entries), with one row of 3,000 entries among the long
    ones; empty rows too."""
    rng = np.random.default_rng(seed)
    n_rows, n_cols = 70, 500
    if classes == "short":
        lens = rng.integers(0, 9, n_rows)
    elif classes == "long":
        lens = rng.integers(9, 60, n_rows)
        lens[5] = 3000
        lens[7] = 0 if not every_row else lens[7]
    else:
        lens = rng.integers(0, 40, n_rows)
        lens[5] = 3000
    rows = np.repeat(np.arange(n_rows), lens)
    cols = rng.integers(0, n_cols, rows.size)
    return ops.csr_pack(rows, cols, rng.normal(size=rows.size), n_rows,
                        n_cols, every_row=every_row, long_row=8)


def _offset(t, card, offset):
    """``t`` on the card at a base address ``offset`` elements into its
    allocation."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=card)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("classes", ["short", "long", "mixed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [7, 256, 500])
@pytest.mark.parametrize("accumulate", [False, True])
def test_csr_spmm_matches_plain(card, classes, dtype, d, accumulate):
    """Both modes at every row class, vector width and feature stripe
    count, aligned and one element past the base address."""
    pack = _csr_case(classes, every_row=not accumulate, seed=d).to(card)
    assert (pack.long_rows.numel() > 0) == (classes != "short")
    assert (pack.short_rows.numel() > 0) == (classes != "long")
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.normal(size=(pack.n_cols, d)).astype(
        np.float32)).to(card, dtype)
    out0 = torch.from_numpy(rng.normal(size=(pack.n_rows, d)).astype(
        np.float32)).to(card, dtype)
    for offset in (0, 1):
        xo = _offset(x, card, offset)
        if accumulate:
            want = ref.csr_spmm_ref(pack, x, out0)
            before = csr_spmm.csr_spmm_accumulate.launches
            got = csr_spmm.csr_spmm_accumulate(pack, xo,
                                               _offset(out0, card, offset))
            assert csr_spmm.csr_spmm_accumulate.launches == before + 1
        else:
            want = ref.csr_spmm_ref(pack, x)
            before = csr_spmm.csr_spmm.launches
            got = csr_spmm.csr_spmm(pack, xo)
            assert csr_spmm.csr_spmm.launches == before + 1
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == (pack.n_rows, d)
        torch.testing.assert_close(got.float(), want.float(),
                                   **_csr_tol(want))


def test_dh_is_bit_reproducible(card):
    """Two backward passes of the hybrid product over its transposed pack
    give the same bits (no atomics), and agree with the CPU's."""
    cols, vals, h = _ell(9, 2, 300, 40, 500, 256, pad=0.5)
    rng = np.random.default_rng(9)
    ts = torch.from_numpy(rng.integers(0, 500, (2, 4000)))
    td = torch.from_numpy(np.minimum(rng.zipf(1.3, (2, 4000)) - 1, 300))
    tw = torch.from_numpy(rng.normal(size=(2, 4000)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, 300, 256)).astype(np.float32))
    dh_pack = ops.transpose_csr(cols, vals, 500, ts, td, tw, long_row=16,
                                device=card)
    tail_pack = ops.tail_csr(ts, td, tw, 300, 500, device=card)
    assert dh_pack.long_rows.numel() and tail_pack.long_rows.numel()
    grads = []
    for _ in range(2):
        x = h.to(card).requires_grad_(True)
        ops.hybrid_spmm(*(t.to(card) for t in (cols, vals, ts, td, tw)), x,
                        tail_pack=tail_pack, dh_pack=dh_pack).backward(
                            g.to(card))
        grads.append(x.grad)
    torch.cuda.synchronize()
    assert torch.equal(grads[0].view(torch.int32), grads[1].view(torch.int32))
    x = h.clone().requires_grad_(True)
    ops.hybrid_spmm(cols, vals, ts, td, tw, x).backward(g)
    torch.testing.assert_close(grads[0].cpu(), x.grad,
                               **_csr_tol(x.grad))


def test_csr_wrappers_refuse_what_they_do_not_take(card):
    pack = _csr_case("mixed", every_row=True).to(card)
    x = torch.zeros((pack.n_cols, 8), device=card)
    out = torch.zeros((pack.n_rows, 8), device=card)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        csr_spmm.csr_spmm(pack, x.double())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        csr_spmm.csr_spmm_accumulate(pack, x, out.to(torch.bfloat16))
    with pytest.raises(TypeError, match="int32"):
        csr_spmm.csr_spmm(dataclasses.replace(pack, col=pack.col.long()), x)
    with pytest.raises(ValueError, match="int32"):
        csr_spmm.csr_spmm(dataclasses.replace(pack, n_cols=2 ** 31), x)
    with pytest.raises(ValueError, match=r"x \["):
        csr_spmm.csr_spmm(pack, x[:-1])
    with pytest.raises(ValueError, match="not on a CUDA device"):
        csr_spmm.csr_spmm(pack, x.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        csr_spmm.csr_spmm_accumulate(pack, x, out.t().contiguous().t())
    with pytest.raises(ValueError, match="every row"):
        csr_spmm.csr_spmm(_csr_case("mixed", every_row=False).to(card), x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_src,n_out,d", [(8925, 64, 7), (300, 130, 500),
                                           (50, 3, 1)])
def test_gather_rows_kernel_bitexact(card, dtype, n_src, n_out, d):
    g = torch.Generator(device=card).manual_seed(n_src + d)
    src = torch.randn((n_src, d), generator=g, device=card).to(dtype)
    idx = torch.randint(0, n_src, (n_out,), generator=g, device=card,
                        dtype=torch.int32)
    before = cache_gather.gather_rows.launches
    got = ops.gather_rows(src, idx)
    want = ref.gather_rows_ref(src, idx)
    torch.cuda.synchronize()
    assert cache_gather.gather_rows.launches == before + 1
    word = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert got.dtype == dtype
    assert torch.equal(got.view(word), want.view(word))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [7, 500])
def test_gather_rows_unaligned_and_out_of_range(card, dtype, d):
    """A src whose base address is one element past an allocation (4- or
    2-byte words), and indices outside [0, n_src): rows of zero bits."""
    n_src = 97
    buf = torch.randn(n_src * d + 1, generator=torch.Generator(device=card)
                      .manual_seed(d), device=card).to(dtype)
    src = buf[1:].view(n_src, d)
    assert src.data_ptr() % 16
    idx = torch.tensor([5, -1, 96, 0, n_src, 40, -7, n_src + 3, 5],
                       dtype=torch.int32, device=card)
    got = ops.gather_rows(src, idx)
    torch.cuda.synchronize()
    want = src[idx.long().clamp(0, n_src - 1)].clone()
    want[(idx < 0) | (idx >= n_src)] = 0
    word = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(word), want.view(word))


def test_gather_rows_empty_index_launches_nothing(card):
    src = torch.randn((10, 7), device=card)
    before = cache_gather.gather_rows.launches
    out = ops.gather_rows(src, torch.zeros(0, dtype=torch.int32, device=card))
    assert out.shape == (0, 7)
    assert cache_gather.gather_rows.launches == before


def test_kernel_wrappers_refuse_what_they_do_not_take(card):
    cols, vals, h = (t.to(card) for t in _ell(0, 1, 8, 3, 10, 4))
    with pytest.raises(TypeError, match="int32"):
        ell_spmm.ell_spmm(cols.long(), vals, h)
    with pytest.raises(TypeError, match="float32"):
        ell_spmm.ell_spmm(cols, vals, h.double())
    with pytest.raises(ValueError, match="contiguous"):
        ell_spmm.ell_spmm(cols, vals, h.transpose(1, 2).contiguous()
                          .transpose(1, 2))
    with pytest.raises(TypeError, match="1-D int32"):
        cache_gather.gather_rows(h[0], torch.zeros(2, dtype=torch.int64,
                                                   device=card))
    with pytest.raises(TypeError, match="row_end must be int32"):
        ell_spmm.ell_spmm(cols, vals, h, torch.zeros((1, 8), device=card))
    with pytest.raises(ValueError, match="row_end"):   # vals are trained
        ops.ell_spmm(cols, vals.clone().requires_grad_(True), h,
                     row_end=_row_end(vals))
    with pytest.raises(ValueError, match="contiguous"):
        cache_gather.gather_rows(h[0].t(), torch.zeros(2, dtype=torch.int32,
                                                       device=card))


def test_serve_slice_on_card_matches_cpu(card):
    """The serving slice at a small size: the card's precompute tables
    equal the CPU's (same parameters) within 1e-5, and the served stream's
    counts are equal; the precompute launches the ELL and tail kernels
    once per layer and builds no pack."""
    from repro_torch.launch.serve import build_parser, serve_gnn

    argv = ["gnn", "--scale", "0.02", "--feat-dim", "32", "--hidden", "32",
            "--backend", "hybrid", "--queries", "300", "--qps", "2000"]
    counters = (ell_spmm.ell_spmm, csr_spmm.csr_spmm_accumulate,
                csr_spmm.csr_spmm)
    counts = [fn.launches for fn in counters]
    builds = ops.pack_for_call.builds
    rep_gpu, eng_gpu = serve_gnn(build_parser().parse_args(
        argv + ["--device", "cuda"]))
    torch.cuda.synchronize()
    # one precompute pass: per layer one ELL and one tail launch, no d_h
    assert [fn.launches - c for fn, c in zip(counters, counts)] == [3, 3, 0]
    assert ops.pack_for_call.builds == builds
    rep_cpu, eng_cpu = serve_gnn(build_parser().parse_args(
        argv + ["--device", "cpu"]))
    for got, want in zip(eng_gpu.store.tables, eng_cpu.store.tables):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for k in ("queries", "batches", "mean_batch", "hot_hit_rate",
              "host_hit_rate", "fresh_rate"):
        assert rep_gpu[k] == rep_cpu[k], k


def test_train_slice_on_card_matches_cpu(card):
    """The training slice at a small size with ``sgd``: the card's 8-epoch
    losses equal the CPU's (same parameters, plain versions) within 1e-5,
    the counts exactly; each step launches the ELL forward 3 times, the CSR
    kernel over the tail 3 times and over the transposed pack (``d_h``)
    twice (layers 1 and 2), ``d_vals`` never, and builds no pack."""
    from repro_torch.core import StalenessController
    from repro_torch.dist import make_sim_runtime, train_capgnn
    from repro_torch.launch.train import build_parser, prepare_train
    from repro_torch.optim import sgd

    args = build_parser().parse_args(
        ["gnn", "--scale", "0.02", "--feat-dim", "32", "--hidden", "32",
         "--backend", "hybrid", "--epochs", "8"])
    ctx = prepare_train(args)
    cfg, spec, xplan = ctx["cfg"], ctx["spec"], ctx["xplan"]
    reps = {}
    for dev in ("cpu", "cuda"):
        rt = make_sim_runtime(cfg, ctx["sp"], xplan, sgd(0.5), spec=spec,
                              device=dev)
        counters = (ell_spmm.ell_spmm, csr_spmm.csr_spmm,
                    csr_spmm.csr_spmm_accumulate, ell_spmm.ell_spmm_dvals)
        counts = [fn.launches for fn in counters]
        builds = ops.pack_for_call.builds
        _, reps[dev] = train_capgnn(
            cfg, rt, xplan, args.parts, sgd(0.5), epochs=8,
            controller=StalenessController(refresh_every=4), spec=spec)
        torch.cuda.synchronize()
        got = tuple(fn.launches - c for fn, c in zip(counters, counts))
        assert got == ((0,) * 4 if dev == "cpu" else (24, 16, 24, 0)), dev
        assert ops.pack_for_call.builds == builds
    np.testing.assert_allclose(reps["cuda"].losses, reps["cpu"].losses,
                               rtol=0, atol=1e-5)
    for k in ("comm_bytes", "comm_bytes_vanilla", "refresh_steps",
              "cached_steps", "step_kinds"):
        assert getattr(reps["cuda"], k) == getattr(reps["cpu"], k), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [7, 256, 500])
def test_gather_backward_on_card_matches_cpu(card, dtype, d):
    """The row gather's backward (the CSR kernel over the transposed index
    map): a ``grad_fn`` on the card, two launches equal bit for bit, and
    the CPU's gradient (the plain version over the same pack) within the
    CSR tolerance; ids repeated up to 300 times (long rows of the map) and
    out of range; the forward bit-exact."""
    rng = np.random.default_rng(d)
    n_src = 400
    idx = rng.integers(-3, n_src + 3, 2000).astype(np.int32)
    idx[:300] = 17                       # one row sent to 300 consumers
    src = torch.from_numpy(rng.normal(size=(n_src, d)).astype(
        np.float32)).to(dtype)
    g = torch.from_numpy(rng.normal(size=(idx.size, d)).astype(
        np.float32)).to(dtype)
    pack = ops.gather_pack(idx, n_src, device=card)
    assert pack.long_rows.numel() > 0
    grads = []
    for _ in range(2):
        x = src.to(card).requires_grad_(True)
        before = (cache_gather.gather_rows.launches,
                  cache_gather.gather_rows_bwd.launches)
        out = ops.gather_rows(x, torch.from_numpy(idx).to(card), pack)
        assert isinstance(out.grad_fn, ops.GatherRowsFn._backward_cls)
        out.backward(g.to(card))
        torch.cuda.synchronize()
        assert (cache_gather.gather_rows.launches,
                cache_gather.gather_rows_bwd.launches) == (before[0] + 1,
                                                           before[1] + 1)
        grads.append(x.grad)
    word = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(grads[0].view(word), grads[1].view(word))
    x = src.clone().requires_grad_(True)
    cpu_out = ops.gather_rows(x, torch.from_numpy(idx), pack.to("cpu"))
    cpu_out.backward(g)
    assert torch.equal(out.detach().cpu().view(word), cpu_out.detach()
                       .view(word))
    torch.testing.assert_close(grads[0].float().cpu(), x.grad.float(),
                               **_csr_tol(x.grad))


def test_gather_rows_keeps_the_graph_on_card(card):
    """``ops.gather_rows`` on a ``src`` that requires a gradient has a
    ``grad_fn`` on the card (a pack built for the call, counted), and under
    ``inference_mode`` is the raw kernel call."""
    src = torch.randn((50, 8), device=card, requires_grad=True)
    idx = torch.tensor([3, 3, 49, 0], dtype=torch.int32, device=card)
    builds = ops.pack_for_call.builds
    out = ops.gather_rows(src, idx)
    assert out.grad_fn is not None
    out.sum().backward()
    torch.cuda.synchronize()
    assert ops.pack_for_call.builds == builds + 1
    want = torch.zeros((50, 8))
    want[3], want[49], want[0] = 2.0, 1.0, 1.0
    torch.testing.assert_close(src.grad.cpu(), want, rtol=0, atol=0)
    with torch.inference_mode():
        assert ops.gather_rows(src, idx).grad_fn is None


@pytest.mark.parametrize("d", [7, 130, 256, 499, 500, 700, 1100])
def test_dvals_kernel_ragged_and_column0(card, d):
    """``d_vals`` at ragged shapes, one stripe or several (d = 1100 at the
    chosen stripe: partial rows summed by the second kernel), every vector
    width, with live slots of column 0 among the padding and columns out
    of range (0); the column-0 slots of a row hold the same bits, and two
    launches give the same bits."""
    p, n, k, nc = 2, 45, 37, 90
    cols, vals, h = _ell(d + 3, p, n, k, nc, d, pad=0.6)
    cols[vals == 0] = 0                  # padding names column 0
    cols[0, 3, 5], vals[0, 3, 5] = 0, 1.5      # live slots of column 0
    cols[1, 44, 36], vals[1, 44, 36] = 0, -2.0
    cols[1, 7, 2], cols[0, 9, 9] = -1, nc + 2  # out of range
    g = torch.from_numpy(np.random.default_rng(d).normal(
        size=(p, n, d)).astype(np.float32))
    cols, vals, h, g = (t.to(card) for t in (cols, vals, h, g))
    before = ell_spmm.ell_spmm_dvals.launches
    got = ell_spmm.ell_spmm_dvals(cols, g, h)
    again = ell_spmm.ell_spmm_dvals(cols, g, h)
    torch.cuda.synchronize()
    assert ell_spmm.ell_spmm_dvals.launches == before + 2
    want = ref.ell_spmm_bwd_ref(cols, vals, h, g, nc, need_h=False)[0]
    torch.testing.assert_close(got, want, **ELL_TOL)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert got[1, 7, 2] == 0 and got[0, 9, 9] == 0
    zero = cols == 0
    for i in range(p):
        for r in range(n):
            v = got[i, r][zero[i, r]]
            assert torch.equal(v, v[:1].expand_as(v)), (i, r)


@pytest.mark.parametrize("stripe_bytes", [256, 512, 1024, 2048])
@pytest.mark.parametrize("lanes", [8, 16, 32])
def test_dvals_every_launch_config(card, stripe_bytes, lanes, monkeypatch):
    """Every stripe and lanes-per-slot the ``d_vals`` kernel is built for
    (the configurations ``chip_smoke.py --sweep`` times), f32 at d = 256,
    500 and 130, against the plain version."""
    monkeypatch.setattr(ell_spmm, "DVALS_STRIPE_BYTES", stripe_bytes)
    monkeypatch.setattr(ell_spmm, "DVALS_LANES", lanes)
    for d in (256, 500, 130):
        cols, vals, h = (t.to(card) for t in _ell(d, 2, 70, 40, 150, d))
        g = torch.randn((2, 70, d), device=card)
        got = ell_spmm.ell_spmm_dvals(cols, g, h)
        torch.cuda.synchronize()
        torch.testing.assert_close(
            got, ref.ell_spmm_bwd_ref(cols, vals, h, g, 150,
                                      need_h=False)[0], **ELL_TOL)


@pytest.mark.parametrize("backend", ["hybrid", "ell", "edges"])
def test_refresh_step_on_card_matches_cpu(card, backend):
    """One refresh step of the training slice at a small size, for each
    backend: the card's loss within 1e-5 of the CPU's and each gradient
    within 2e-3 of its largest magnitude (``chip_smoke.py``'s train
    tolerances), the tier pulls' gradients through the gather backward
    (once per differentiated non-empty pull and exchanged layer), and no
    pack built for a call."""
    from repro_torch.dist import make_sim_runtime
    from repro_torch.launch.train import build_parser, prepare_train
    from repro_torch.models.gnn import init_gnn
    from repro_torch.optim import adam

    args = build_parser().parse_args(
        ["gnn", "--scale", "0.02", "--feat-dim", "32", "--hidden", "32",
         "--backend", backend, "--epochs", "1"])
    ctx = prepare_train(args)
    cfg, spec, xplan = ctx["cfg"], ctx["spec"], ctx["xplan"]
    params = init_gnn(cfg, torch.Generator().manual_seed(0), "cpu")
    res = {}
    for dev in ("cpu", card):
        rt = make_sim_runtime(cfg, ctx["sp"], xplan, adam(0.01), spec=spec,
                              device=dev)
        builds = ops.pack_for_call.builds
        bwd = cache_gather.gather_rows_bwd.launches
        loss, grads = rt.loss_and_grads(
            [{k: v.to(dev) for k, v in p.items()} for p in params],
            rt.caches0)
        if dev == card:
            torch.cuda.synchronize()
            # on an f32 halo, one gather per tier pull with a non-empty
            # index, read from the plan: the uncached and local tiers, the
            # global buffer's fill and its reads
            pulls = (xplan.uncached.recv_src_part, xplan.local.recv_src_part,
                     xplan.glob.src_part, xplan.glob.read_buf_idx)
            want = (cfg.num_layers - 1) * sum(int(np.asarray(a).size > 0)
                                              for a in pulls)
            assert want > 0
            assert cache_gather.gather_rows_bwd.launches - bwd == want
        assert ops.pack_for_call.builds == builds
        res[str(dev)] = (float(loss), [{k: v.cpu() for k, v in g.items()}
                                       for g in grads])
    (lc, gc), (lg, gg) = res["cpu"], res[str(card)]
    assert abs(lg - lc) <= 1e-5
    for a, b in zip(gg, gc):
        for k in b:
            rel = float((a[k] - b[k]).abs().max()) / (
                float(b[k].abs().max()) + 1e-12)
            assert rel <= 2e-3, (k, rel)
