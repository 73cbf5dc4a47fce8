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
``ell``, ``edges``), and for SAGE, GIN and GAT, matches the CPU within the
train slice's tolerances.  The edge list's route: its forward and ``d_h``
(the CSR kernel over its packs) and the ``edge_dvals`` kernel against
their plain versions at every lane and stripe configuration (``d_vals``
twice bit for bit), ``EdgeListAdj.spmm`` / ``spmm_at`` against the CPU's
``coo_spmm`` with their gradients, an edge list on the card without packs
refused, and the packs built on the card equal to the CPU's.  The CSR
kernel's load modes (two or four register steps, the cp.async ring) at
every stripe over a pack in its own and a shuffled row order (long
rows, empty rows, ragged widths, bf16, accumulate mode, two launches bit
for bit); GAT's edge softmax (``csrc/edge_softmax.cu``: both entry points
against their plain versions at 1, 2, 3, 4, 8 and 16 heads with long
and empty rows and at every class of the lanes a row (0-257 entries, 2
to 40 segments), twice bit for bit, ``d_att`` in the pack's order;
``ops.edge_attention`` against the CPU's at 4 heads of 64 and head width
1, one launch of each kernel; GAT on the card without packs refused);
GAT's heads (4, and 1) in
one launch of the CSR kernel and of
``edge_dvals`` (against the plain versions and one launch a head, bit
for bit twice, 0 at padding), and ``EdgeListAdj.spmm_at`` of ``[P, m,
H]`` values
against the CPU's head loop; the profiler's busy time within the wall
time with ``device_scope`` ranges open.  ``EllAdj.spmm_at`` (trained ELL values) runs
the ``d_vals`` kernel and a ``d_h`` launch, each against the CPU; GAT's
stacked gradients stay finite over padding edges.  The host store drops
an injected fetch before it takes a pinned ring slot, and a slot's wait
and growth stay out of ``gather_s`` (an injected delay shows); the tracer's
``device_peak_bytes`` is the allocator's peak and its fence synchronises
the value's stream (not the card) only when enabled.  The transformer
zoo's SPMD half: the ``staged`` process group's collectives of CUDA
tensors equal gloo's of the same CPU tensors, ``shard_params`` places
each shard on the card, and the op counter counts a matmul of CUDA
tensors.  The zoo's attention: the flash forward and its two backward
launches at every listed head width, f32 and bf16, causal or not, with a
window, GQA groups of 1 to 4 (f32 within 1e-5 of the largest magnitude;
bf16 within 2^-7 of the larger of the output's and V's, gradients 2^-6:
P and dS as two bf16 parts, and bf16 rounding); the backward pair
(``csrc/flash_attn_bwd.cu``, ``wgmma`` over TMA tiles in bf16) at S
about its tiles (1, 63, 64, 129, 200, 257), B = 2, every width, group
and mask, and on bf16 views 2 bytes past a 16-byte boundary;
``csrc/hopper.cuh``'s primitives each on its own (a TMA tile
in and out with its swizzle, one tile read by ``wgmma`` K-major from
shared memory and MN-major beside register A fragments, producer and
consumer warpgroups after ``setmaxnreg``); the decode kernel at every
decode width and groups of 1, 2, 5 and 6 with a row of no valid slot, all
twice bit for bit; the model's attention on CUDA tensors launching each
kernel once; unlisted widths, dtypes and a window without causality
refused; a reduced step traced on ``cuda`` fakes counting what it counts
on ``cpu`` fakes.
"""
import numpy as np
import pytest
import torch

import dataclasses
import time

from repro_torch.kernels import cache_gather, csr_spmm, ell_spmm, ops, ref
from repro_torch.dist import HostFeatureStore
from repro_torch.faults import FaultPlan, FetchError
from repro_torch.obs import NULL_TRACER, Tracer, device_peak_bytes
from torch_threads import torch_threads_per_worker  # noqa: F401

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
    _refresh_card_vs_cpu(card, backend, "gcn")


@pytest.mark.parametrize("model,backend", [
    ("sage", "hybrid"), ("sage", "ell"), ("sage", "edges"),
    ("gin", "hybrid"), ("gin", "ell"), ("gat", "edges")])
def test_model_refresh_step_on_card_matches_cpu(card, model, backend):
    """:func:`test_refresh_step_on_card_matches_cpu` for SAGE, GIN (its
    0-d ``eps`` gradient among the held ones) and GAT."""
    _refresh_card_vs_cpu(card, backend, model)


def _refresh_card_vs_cpu(card, backend, model):
    from repro_torch.dist import make_sim_runtime
    from repro_torch.launch.train import build_parser, prepare_train
    from repro_torch.models.gnn import init_gnn
    from repro_torch.optim import adam

    args = build_parser().parse_args(
        ["gnn", "--scale", "0.02", "--feat-dim", "32", "--hidden", "32",
         "--backend", backend, "--model", model, "--epochs", "1"])
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


def _spmd_refresh_on_card(card, backend, devices):
    """One refresh step of the SPMD runtime on the card over ``backend``
    (2 ranks, the graph of ``tests/spmd_parity_script.py`` in 2 METIS
    parts under a forced-capacity plan, every tier non-empty), against the
    card's single-process runtime on the same parameters: the loss within
    1e-5 and each gradient within 1e-5 of its largest magnitude, and the
    counted rows equal to the plan's."""
    from repro_torch.core import CacheCapacity, build_cache_plan
    from repro_torch.data.gnn_data import FullBatchTask, split_masks
    from repro_torch.dist import (TrainSpec, build_exchange_plan,
                                  make_sim_runtime, stack_partitions)
    from repro_torch.graph import (build_partition, metis_partition, rmat,
                                   symmetric_normalize, synth_features)
    from repro_torch.launch.mesh import spawn
    from repro_torch.models.gnn import GNNConfig, init_gnn
    from repro_torch.optim import sgd
    import torch_spmd_ranks

    g = rmat(360, 2200, seed=3)
    feats, labels = synth_features(g, 12, 5, seed=3)
    gn = symmetric_normalize(g)
    tr, va, te = split_masks(g.num_nodes, seed=3)
    task = FullBatchTask(graph=gn, features=feats, labels=labels,
                         train_mask=tr, val_mask=va, test_mask=te,
                         num_classes=5)
    ps = build_partition(gn, metis_partition(gn, 2, seed=3), hops=1)
    xplan = build_exchange_plan(ps, build_cache_plan(
        ps, CacheCapacity(c_gpu=[10] * 2, c_cpu=25), refresh_every=2))
    assert xplan.uncached.n_rows and xplan.local.n_rows \
        and xplan.glob.n_unique
    cfg = GNNConfig(model="gcn", in_dim=12, hidden_dim=16, out_dim=5,
                    num_layers=3)
    params = init_gnn(cfg, torch.Generator().manual_seed(0), "cpu")
    params_np = [{k: v.numpy() for k, v in p.items()} for p in params]
    for transport in ("p2p", "allgather"):
        kw = dict(backend="hybrid", transport=transport)
        sp = stack_partitions(ps, task, backend="hybrid")
        ranks = spawn(torch_spmd_ranks.run_refresh, 2, backend=backend,
                      devices=devices,
                      args=(cfg, sp, xplan, kw, params_np))
        sim = make_sim_runtime(cfg, sp, xplan, sgd(1.0),
                               spec=TrainSpec(**kw), device=card)
        loss, grads = sim.loss_and_grads(
            [{k: v.to(card) for k, v in p.items()} for p in params],
            sim.caches0)
        for r in ranks:
            assert abs(r["loss"] - float(loss)) <= 1e-5
            for a, b in zip(r["grads"], grads):
                for k in b:
                    want = b[k].cpu().numpy()
                    err = np.abs(a[k] - want).max() / (np.abs(want).max()
                                                       + 1e-12)
                    assert err <= 1e-5, (transport, k, err)
        rows = xplan.transport_rows(transport, True)
        for li in (1, 2):
            for t in ("uncached", "local", "global"):
                got = sum(r["wire"]["counts"][(li, t)]["valid_rows"]
                          for r in ranks)
                assert got == rows[t], (transport, li, t)
        staged = sum(r["wire"]["host_stage_s"] for r in ranks)
        assert (staged > 0) == (backend == "gloo")


def test_spmd_refresh_step_on_one_card_over_gloo(card):
    """Two ranks share the card over gloo: the wire stages through the
    host (``host_stage_s`` > 0)."""
    _spmd_refresh_on_card(card, "gloo", ["cuda:0", "cuda:0"])


def test_spmd_refresh_step_over_nccl(card):
    """Two ranks on two cards over NCCL (no host staging)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("NCCL needs one card per rank: fewer than 2 visible")
    _spmd_refresh_on_card(card, "nccl", "cuda")


def test_host_ring_slot_reuse_under_a_slow_consumer(card):
    """The store's ring of 2 pinned slots under a slow side stream and a
    slow consumer: a third fetch waits for the first one's copy before it
    rewrites that slot, so every consumed fetch holds the rows it was
    staged with, bit for bit; the copy and wait events read back
    positive device time."""
    from repro_torch.dist.host_store import HostFeatureStore
    rng = np.random.default_rng(0)
    feat = rng.normal(size=(3, 4000, 64)).astype(np.float32)
    store = HostFeatureStore(feat, prefetch_depth=2, device=card)
    store.timing = True
    parts = np.arange(3)[:, None]
    fetches, want = [], []
    for i in range(5):
        pos = rng.integers(0, 4000, (3, 3000))
        valid = rng.random((3, 3000)) < 0.8
        fetches.append(store.stage_rows((parts, pos), valid=valid))
        want.append(np.where(valid[..., None], feat[parts, pos], 0.0))
        with torch.cuda.stream(store._side):
            torch.cuda._sleep(50_000_000)       # hold the next copy back
    torch.cuda._sleep(100_000_000)              # a slow consumer
    for sf, w in zip(fetches, want):
        np.testing.assert_array_equal(store.ready(sf).cpu().numpy(), w)
    times = store.copy_times()
    assert times["h2d_rows"] > 0.0 and times["wait_rows"] >= 0.0
    assert len(store.copy_log) == 10        # 5 copies, 5 waits
    assert len(store._slots[torch.float32]) == 2


@pytest.mark.parametrize("halo_dtype", ["f32", "bf16"])
def test_host_mode_equals_device_mode_on_card(card, halo_dtype):
    """The parity graph (forced capacity: every tier holds rows), hybrid:
    the host-features runtime through refresh, cached, pipelined, a
    transition to a second ranking, ``set_plan`` back and a refresh,
    against the device-features runtime on the card — bit for bit in f32,
    within 5e-3 in bf16 — and the store's consumed rows equal the plan's
    count."""
    from repro_torch.core import CacheCapacity, build_cache_plan
    from repro_torch.data.gnn_data import FullBatchTask, split_masks
    from repro_torch.dist import (TrainSpec, build_exchange_plan,
                                  exchange_capacity, make_sim_runtime,
                                  stack_partitions)
    from repro_torch.graph import (build_partition, metis_partition, rmat,
                                   symmetric_normalize, synth_features)
    from repro_torch.models.gnn import GNNConfig, init_gnn
    from repro_torch.optim import sgd
    g = rmat(360, 2200, seed=3)
    feats, labels = synth_features(g, 12, 5, seed=3)
    gn = symmetric_normalize(g)
    tr, va, te = split_masks(g.num_nodes, seed=3)
    task = FullBatchTask(graph=gn, features=feats, labels=labels,
                         train_mask=tr, val_mask=va, test_mask=te,
                         num_classes=5)
    ps = build_partition(gn, metis_partition(gn, 4, seed=3), hops=1)
    cap = CacheCapacity(c_gpu=[8] * 4, c_cpu=30)
    plans = [build_exchange_plan(ps, build_cache_plan(
        ps, cap, refresh_every=3, policy=pol, seed=1),
        pad_to=exchange_capacity(ps, cap))
        for pol in ("overlap_high", "random")]
    cfg = GNNConfig(model="gcn", in_dim=12, hidden_dim=16, out_dim=5,
                    num_layers=3)
    sp = stack_partitions(ps, task, backend="hybrid")
    spec = TrainSpec(backend="hybrid", halo_dtype=halo_dtype)
    opt = sgd(0.5)
    dev = make_sim_runtime(cfg, sp, plans[0], opt, spec=spec, device=card)
    host = make_sim_runtime(cfg, sp, plans[0], opt, device=card,
                            spec=dataclasses.replace(spec, features="host"))
    params = init_gnn(cfg, torch.Generator().manual_seed(0), card)
    sd, sh = (params, (), dev.caches0), (params, (), host.caches0)
    snap, expected = host.host_store.snapshot(), 0
    for kind, plan in (("refresh", None), ("cached", None),
                       ("pipelined", None), ("transition", 1),
                       ("cached", None), ("refresh", 0)):
        per = host.xplan.host_fetch_rows(True, 2)
        if kind == "transition":
            *sd, md = dev.step_transition(*sd, plans[plan])
            *sh, mh = host.step_transition(*sh, plans[plan])
            expected += per["total"] + plans[plan].local.n_rows
        else:
            if plan is not None:
                dev.set_plan(plans[plan])
                host.set_plan(plans[plan])
                expected += plans[plan].local.n_rows
                per = host.xplan.host_fetch_rows(True, 2)
            *sd, md = getattr(dev, f"step_{kind}")(*sd)
            *sh, mh = getattr(host, f"step_{kind}")(*sh)
            expected += per["l0"] if kind == "refresh" else per["total"]
        for a, b in zip(sd[0], sh[0]):
            for k in a:
                if halo_dtype == "f32":
                    assert torch.equal(a[k], b[k]), (kind, k)
                else:
                    assert float((a[k] - b[k]).abs().max()) <= 5e-3, kind
    torch.cuda.synchronize()
    assert host.host_store.delta(snap)["fetch_rows"] == expected


def test_ell_spmm_at_on_card_matches_cpu(card):
    """``EllAdj.spmm_at`` (trained values): its forward, the ``d_vals``
    kernel and ``d_h`` over a pack built for the call, against the CPU's
    plain versions; one ``d_vals`` launch, one ``d_h`` launch."""
    from repro_torch.graph import rmat, symmetric_normalize
    from repro_torch.models.gnn import make_local_adj
    g = symmetric_normalize(rmat(300, 2400, seed=4))
    rng = np.random.default_rng(4)
    res = {}
    for dev in ("cpu", card):
        adj = make_local_adj(g, 250, "ell", device=dev)
        e = torch.as_tensor(rng.normal(size=tuple(adj.vals.shape)).astype(
            np.float32)) if dev == "cpu" else res["cpu"]["e"]
        h = torch.as_tensor(rng.normal(size=(300, 64)).astype(np.float32)) \
            if dev == "cpu" else res["cpu"]["h"]
        gout = torch.as_tensor(rng.normal(size=(250, 64)).astype(
            np.float32)) if dev == "cpu" else res["cpu"]["g"]
        te = e.detach().to(dev).requires_grad_(True)
        th = h.detach().to(dev).requires_grad_(True)
        launches = (ell_spmm.ell_spmm_dvals.launches,
                    csr_spmm.csr_spmm.launches)
        out = adj.spmm_at(te, th)
        (out * gout.to(dev)).sum().backward()
        if dev == card:
            torch.cuda.synchronize()
            assert (ell_spmm.ell_spmm_dvals.launches - launches[0],
                    csr_spmm.csr_spmm.launches - launches[1]) == (1, 1)
        res[str(dev)] = {"e": e, "h": h, "g": gout, "out": out.detach().cpu(),
                         "de": te.grad.cpu(), "dh": th.grad.cpu()}
    c, k = res["cpu"], res[str(card)]
    torch.testing.assert_close(k["out"], c["out"], **ELL_TOL)
    torch.testing.assert_close(k["de"], c["de"], **ELL_TOL)
    torch.testing.assert_close(k["dh"], c["dh"], **_csr_tol(c["dh"]))
    assert (c["de"][adj.vals.cpu() == 0] == 0).all()


def test_gat_padded_edge_grads_finite_on_card(card):
    """One GAT layer over the stacked edge list of 4 uneven partitions
    (padding edges with ``dst == n_inner_max`` in every partition with
    fewer inner rows), with its CSR packs: gradients finite on the card
    (through the edge kernels) and within 1e-5 of their largest magnitude
    of the CPU's."""
    from repro_torch.data.gnn_data import FullBatchTask, split_masks
    from repro_torch.dist import stack_partitions
    from repro_torch.graph import (build_partition, metis_partition, rmat,
                                   symmetric_normalize, synth_features)
    from repro_torch.models.gnn import (EdgeListAdj, GNNConfig, _layer_apply,
                                        init_gnn)
    g = rmat(360, 2200, seed=3)
    feats, labels = synth_features(g, 12, 5, seed=3)
    gn = symmetric_normalize(g)
    tr, va, te = split_masks(g.num_nodes, seed=3)
    task = FullBatchTask(graph=gn, features=feats, labels=labels,
                         train_mask=tr, val_mask=va, test_mask=te,
                         num_classes=5)
    sp = stack_partitions(build_partition(gn, metis_partition(gn, 4, seed=3),
                                          hops=1), task)
    ni, nl = sp.n_inner_max, sp.n_inner_max + sp.n_halo_max
    assert (sp.n_inner < ni).any() and (sp.e_dst == ni).any()
    cfg = GNNConfig(model="gat", in_dim=12, hidden_dim=64, out_dim=5)
    p0 = init_gnn(cfg, torch.Generator().manual_seed(0), "cpu")[0]
    rng = np.random.default_rng(0)
    h = torch.as_tensor(rng.normal(size=(4, nl, 12)).astype(np.float32))
    gout = torch.as_tensor(rng.normal(size=(4, ni, 64)).astype(np.float32))
    grads = {}
    for dev in ("cpu", card):
        adj = EdgeListAdj(*(torch.as_tensor(a).to(dev) for a in (
            sp.e_src.astype(np.int64), sp.e_dst.astype(np.int64), sp.e_w)),
            ni, nl, ops.edge_packs(*(torch.as_tensor(a).to(dev) for a in (
                sp.e_src, sp.e_dst, sp.e_w)), ni, nl))
        p = {k: v.detach().to(dev).requires_grad_(True)
             for k, v in p0.items()}
        out = _layer_apply(cfg, p, adj, h.to(dev), ni, False)
        (out * gout.to(dev)).sum().backward()
        grads[str(dev)] = {k: v.grad.cpu() for k, v in p.items()}
    for k, want in grads["cpu"].items():
        got = grads[str(card)][k]
        assert torch.isfinite(got).all(), k
        torch.testing.assert_close(
            got, want, rtol=0.0, atol=1e-5 * float(want.abs().max()))


def _edge_case(seed, n_parts=3, n_rows=300, n_cols=500, m=6000):
    """A stacked edge list with power-law in-degrees (long rows at
    ``long_row=16``), padding edges and an empty row."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_cols, (n_parts, m)).astype(np.int32)
    dst = np.minimum(rng.zipf(1.3, (n_parts, m)) - 1, n_rows).astype(
        np.int32)
    dst[dst == 3] = 4
    w = rng.normal(size=(n_parts, m)).astype(np.float32)
    w[dst == n_rows] = 0
    return src, dst, w


@pytest.mark.parametrize("d", [1, 7, 64, 256, 500, 1100])
def test_edge_kernels_match_plain(card, d):
    """The edge list's forward and ``d_h`` (the CSR kernel over its packs,
    counted as ``edge_spmm`` / ``edge_spmm_dh``) and ``edge_dvals`` against
    their plain versions over the same packs, at every lanes-per-entry
    and stripe count; ``edge_dvals`` twice bit for bit, 0 at padding."""
    from repro_torch.kernels import edge_spmm as kedge
    src, dst, w = _edge_case(d)
    packs = ops.edge_packs(*(torch.as_tensor(a).to(card) for a in (
        src, dst, w)), 300, 500, long_row=16)
    assert packs.fwd.long_rows.numel() and packs.fwd.short_rows.numel()
    rng = np.random.default_rng(d)
    h = torch.from_numpy(rng.normal(size=(3 * 500, d)).astype(
        np.float32)).to(card)
    g = torch.from_numpy(rng.normal(size=(3 * 300, d)).astype(
        np.float32)).to(card)
    n = [kedge.edge_spmm.launches, kedge.edge_spmm_dh.launches,
         kedge.edge_dvals.launches]
    fwd = kedge.edge_spmm(packs.fwd, h)
    dh = kedge.edge_spmm_dh(packs.bwd, g)
    dv = [kedge.edge_dvals(packs.fwd, g, h, 3 * 6000) for _ in range(2)]
    torch.cuda.synchronize()
    assert [kedge.edge_spmm.launches - n[0],
            kedge.edge_spmm_dh.launches - n[1],
            kedge.edge_dvals.launches - n[2]] == [1, 1, 2]
    want = ref.csr_spmm_ref(packs.fwd, h)
    torch.testing.assert_close(fwd, want, **_csr_tol(want))
    want = ref.csr_spmm_ref(packs.bwd, g)
    torch.testing.assert_close(dh, want, **_csr_tol(want))
    assert torch.equal(dv[0].view(torch.int32), dv[1].view(torch.int32))
    want = ref.edge_dvals_ref(packs.fwd, g, h, 3 * 6000)
    torch.testing.assert_close(dv[0], want, **ELL_TOL)
    assert not dv[0][torch.from_numpy(dst == 300).reshape(-1)].any()


@pytest.mark.parametrize("at", [False, True], ids=["spmm", "spmm_at"])
def test_edge_list_adj_on_card_matches_cpu(card, at):
    """``EdgeListAdj.spmm`` / ``spmm_at`` on the card (the kernels over
    its packs) against the CPU's ``coo_spmm``: the output, ``d_h`` and
    ``d_e_vals``; no launch of ``coo_spmm``'s route is possible (the card
    has none), and an edge list on the card without packs raises."""
    from repro_torch.kernels import edge_spmm as kedge
    from repro_torch.models.gnn import EdgeListAdj
    src, dst, w = _edge_case(11)
    rng = np.random.default_rng(11)
    h0 = rng.normal(size=(3, 500, 64)).astype(np.float32)
    g0 = rng.normal(size=(3, 300, 64)).astype(np.float32)
    e0 = rng.normal(size=(3, 6000)).astype(np.float32)
    res = {}
    for dev in ("cpu", card):
        s_, d_, w_ = (torch.as_tensor(a).to(dev) for a in (
            src.astype(np.int64), dst.astype(np.int64), w))
        adj = EdgeListAdj(s_, d_, w_, 300, 500,
                          ops.edge_packs(s_, d_, w_, 300, 500))
        h = torch.from_numpy(h0).to(dev).requires_grad_(True)
        e = torch.from_numpy(e0).to(dev).requires_grad_(True)
        n = kedge.edge_dvals.launches
        out = adj.spmm_at(e, h) if at else adj.spmm(h)
        out.backward(torch.from_numpy(g0).to(dev))
        if dev == card:
            assert kedge.edge_dvals.launches - n == int(at)
        res[str(dev)] = (out.detach().cpu(), h.grad.cpu(),
                         None if e.grad is None else e.grad.cpu())
    (oc, hc, ec), (og, hg, eg) = res["cpu"], res[str(card)]
    torch.testing.assert_close(og, oc, **_csr_tol(oc))
    torch.testing.assert_close(hg, hc, **_csr_tol(hc))
    if at:
        torch.testing.assert_close(eg, ec, **ELL_TOL)
    bare = EdgeListAdj(*(torch.as_tensor(a).to(card) for a in (
        src.astype(np.int64), dst.astype(np.int64), w)), 300, 500)
    with pytest.raises(ValueError, match="needs its CSR packs"):
        bare.spmm(torch.from_numpy(h0).to(card))


def test_csr_pack_torch_on_card_equals_host(card):
    """The edge packs built on the card (``csr_pack_torch``'s sort, counts
    and row classes on the device) give the CPU's fields bit for bit,
    long rows and empty rows included."""
    src, dst, w = _edge_case(12)
    want = ops.edge_packs(*(torch.as_tensor(a) for a in (src, dst, w)),
                          300, 500, long_row=16)
    got = ops.edge_packs(*(torch.as_tensor(a).to(card) for a in (
        src, dst, w)), 300, 500, long_row=16)
    for name in ("fwd", "bwd"):
        a, b = getattr(got, name), getattr(want, name)
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(y, torch.Tensor):
                assert x.is_cuda and torch.equal(x.cpu(), y), (name, f.name)
            else:
                assert x == y, (name, f.name)


# ---------------------------------------------------- faults and the tracer

def test_dropped_fetch_leaks_no_ring_slot(card):
    """On the card a dropped stage op takes no pinned slot, records no
    event and issues no copy: the ring hands out its slots in the same
    order as a store that never saw the drop."""
    table = np.arange(400, dtype=np.float32).reshape(100, 4)
    store = HostFeatureStore(table, prefetch_depth=2, device=card)
    fp = FaultPlan.parse("fetch_drop@1")
    store.set_faults(fp)
    first = store.stage_rows(np.arange(8))
    fp.begin_step(1)
    with pytest.raises(FetchError):
        store.stage_rows(np.arange(8, 16))
    fp.end_run()
    assert store._next[torch.float32] == 1
    second = store.stage_rows(np.arange(16, 24))
    assert store._next[torch.float32] == 0
    np.testing.assert_array_equal(store.ready(first).cpu().numpy(),
                                  table[:8])
    np.testing.assert_array_equal(store.ready(second).cpu().numpy(),
                                  table[16:24])
    assert store.snapshot()["fetches"] == 0


def test_slot_wait_and_growth_are_not_gather_time(card, monkeypatch):
    """A ring slot's wait for its last copy and its growth (pinning at a
    first large fetch) stay out of ``gather_s``, which the guard reads for
    slow fetches; an injected delay still shows in it."""
    from repro_torch.dist import host_store as hs
    table = np.arange(400, dtype=np.float32).reshape(100, 4)
    store = HostFeatureStore(table, prefetch_depth=2, device=card)
    real_take = hs._Slot.take

    def slow_take(self, numel, dtype):
        time.sleep(0.2)
        return real_take(self, numel, dtype)
    monkeypatch.setattr(hs._Slot, "take", slow_take)
    sf = store.stage_rows(np.arange(8))
    assert sf.gather_s < 0.1
    fp = FaultPlan.parse("fetch_delay@1:delay_s=0.15")
    store.set_faults(fp)
    fp.begin_step(1)
    delayed = store.stage_rows(np.arange(8, 16))
    fp.end_run()
    assert 0.15 <= delayed.gather_s < 0.3
    np.testing.assert_array_equal(store.ready(sf).cpu().numpy(), table[:8])
    np.testing.assert_array_equal(store.ready(delayed).cpu().numpy(),
                                  table[8:16])


def test_device_peak_bytes_on_card(card):
    torch.cuda.reset_peak_memory_stats(card)
    x = torch.empty(1 << 20, device=card)
    got = device_peak_bytes(card)
    assert got == torch.cuda.max_memory_allocated(card) >= x.numel() * 4


def test_fence_syncs_the_card(card, monkeypatch):
    """The fence waits for the current stream of the value's device (the
    work queued there up to the fence), and never for the whole device:
    a copy queued on a side stream stays in flight."""
    calls = []
    real = torch.cuda.current_stream
    x = torch.ones(4, device=card)
    side = torch.cuda.Stream(card)
    with torch.cuda.stream(side):
        torch.cuda._sleep(int(2e8))         # ~0.1 s of spinning on side

    def current(device=None):
        s = real(device)
        calls.append(device)
        return s

    def device_wide(device=None):
        raise AssertionError("the fence waited on the whole device")
    monkeypatch.setattr(torch.cuda, "current_stream", current)
    monkeypatch.setattr(torch.cuda, "synchronize", device_wide)
    NULL_TRACER.fence(x)
    assert calls == []
    assert Tracer().fence(x) is x and calls == [x.device]
    assert not side.query()                 # the side stream still runs
    side.synchronize()


# ---------------------------------------------------------------------------
# the transformer zoo: card against CPU (plain torch on both: no kernel)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3_1_7b", "hymba_1_5b"])
def test_lm_reduced_on_card_matches_cpu(card, arch):
    """A reduced config in f32 from the same parameters: prefill logits,
    one step's gradients and 8 decode steps on the card within 1e-4 of the
    largest magnitude of the CPU's (S = 40: hymba's window 32 banded)."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.transformer import (forward, init_decode_cache,
                                                init_model, loss_and_grads,
                                                serve_step)
    from repro_torch.optim.optimizers import tree_leaves, tree_map
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    params = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    on_card = tree_map(lambda t: t.to(card), params)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 40)))
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    cbatch = {k: v.to(card) for k, v in batch.items()}

    def close(got, want):
        scale = float(want.abs().max())
        assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale

    close(forward(cfg, on_card, cbatch)[0], forward(cfg, params, batch)[0])
    _, _, g_card = loss_and_grads(cfg, on_card, cbatch)
    _, _, g_cpu = loss_and_grads(cfg, params, batch)
    for a, b in zip(tree_leaves(g_card), tree_leaves(g_cpu)):
        close(a, b)
    caches = [init_decode_cache(cfg, 2, 16, dev) for dev in (card, "cpu")]
    for t in range(8):
        tok = toks[:, t:t + 1]
        lg_card, caches[0] = serve_step(cfg, on_card, caches[0],
                                        tok.to(card), t)
        lg_cpu, caches[1] = serve_step(cfg, params, caches[1], tok, t)
        close(lg_card, lg_cpu)


# ---------------------------------------------------------------------------
# The transformer zoo's SPMD half on the card
# ---------------------------------------------------------------------------

def test_staged_collectives_match_cpu(card):
    """The ``staged`` group (ranks sharing the card): all-gather,
    reduce-scatter, all-reduce and all-to-all of CUDA tensors equal the
    same collectives of CPU tensors."""
    from repro_torch.launch.mesh import spawn
    import torch_lm_spmd_ranks
    diffs = spawn(torch_lm_spmd_ranks.staged_collectives_rank, 2,
                  backend="staged", devices=["cuda:0"] * 2)[0]
    assert diffs == {"all-gather": 0.0, "reduce-scatter": 0.0,
                     "all-reduce": 0.0, "all-to-all": 0.0}


def test_shard_params_on_a_cuda_mesh(card):
    from repro_torch.launch.mesh import spawn
    import torch_lm_spmd_ranks
    err, devices = spawn(torch_lm_spmd_ranks.cuda_shards_rank, 2,
                         backend="staged", devices=["cuda:0"] * 2,
                         args=((1, 2),))[0]
    assert err == 0.0
    assert devices == ["cuda:0"]


def test_counter_on_cuda_tensors(card):
    from repro_torch.launch.hlo_cost import analyse_ops
    a = torch.ones(64, 32, device=card)
    b = torch.ones(32, 16, device=card)
    out, cost = analyse_ops(torch.mm, a, b)
    assert out.is_cuda
    assert cost.flops == 2 * 64 * 32 * 16
    assert cost.bytes_accessed == 4 * (64 * 32 + 32 * 16 + 64 * 16)



# the CSR kernel's modes and stripes, GAT's heads in one launch (the
# kernel's grid z), edge_dvals over heads, and the profiler's busy sum

CSR_MODE_CASES = [(torch.float32, 500, False), (torch.float32, 7, True),
                  (torch.bfloat16, 256, True), (torch.bfloat16, 500, False)]


@pytest.mark.parametrize("mode", list(csr_spmm.MODES))
@pytest.mark.parametrize("stripe_bytes", [256, 512, 1024])
@pytest.mark.parametrize("dtype,d,accumulate", CSR_MODE_CASES,
                         ids=["f32-500-write", "f32-7-acc", "bf16-256-acc",
                              "bf16-500-write"])
def test_csr_modes_and_stripes_match_plain(card, mode, stripe_bytes, dtype,
                                           d, accumulate):
    """Every load mode (registers two or four steps deep, the cp.async
    ring; 16-byte words take all three, narrower ones fall to two steps
    in registers) at every stripe, over a pack with long rows (segments),
    empty rows and ragged widths, its short rows in the pack's order and
    shuffled, in both modes and both types: against the plain version,
    and two write-mode launches bit for bit."""
    config = (stripe_bytes, mode)
    rng = np.random.default_rng(d + stripe_bytes)
    n_rows, n_cols = 400, 500
    lens = rng.integers(0, 40, n_rows)
    lens[[5, 77, 300]] = (3000, 700, 90)
    lens[[7, 8, 350]] = 0
    rows = np.repeat(np.arange(n_rows), lens)
    pack = ops.csr_pack(rows, rng.integers(0, n_cols, rows.size),
                        rng.normal(size=rows.size), n_rows, n_cols,
                        every_row=not accumulate, long_row=64,
                        device=card)
    assert pack.long_rows.numel() and pack.short_rows.numel()
    x = torch.from_numpy(rng.normal(size=(n_cols, d)).astype(
        np.float32)).to(card, dtype)
    out0 = torch.from_numpy(rng.normal(size=(n_rows, d)).astype(
        np.float32)).to(card, dtype)
    shuffled = dataclasses.replace(pack, short_rows=pack.short_rows[
        torch.randperm(pack.short_rows.numel(), device=card)])
    want = ref.csr_spmm_ref(pack, x, out0 if accumulate else None)
    for p in (pack, shuffled):
        if accumulate:
            got = out0.clone()
            assert csr_spmm._run("csr_spmm_accumulate", p, x, got, True,
                                 config)
        else:
            got = csr_spmm.write_mode("csr_spmm", p, x, config)[0]
            again = csr_spmm.write_mode("csr_spmm", p, x, config)[0]
            bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
            assert torch.equal(got.view(bits), again.view(bits))
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(),
                                   **_csr_tol(want))


@pytest.mark.parametrize("heads", [1, 4])
@pytest.mark.parametrize("mode", list(csr_spmm.MODES))
@pytest.mark.parametrize("dh", [6, 64, 100])
def test_csr_heads_in_one_launch(card, mode, dh, heads):
    """A pack valued per head (``w [H, nnz]``, H = 1 too) and ``x [n, H,
    dh]``: one launch (the kernel's grid z) gives each head's product,
    equal to the plain version and to one launch a head over that head's
    columns, in the same bits twice."""
    src, dst, w = _edge_case(dh)
    packs = ops.edge_packs(*(torch.as_tensor(a).to(card) for a in (
        src, dst, w)), 300, 500, long_row=16)
    rng = np.random.default_rng(dh)
    e = torch.from_numpy(rng.normal(size=(3, 6000, heads)).astype(
        np.float32)).to(card)
    x = torch.from_numpy(rng.normal(size=(3 * 500, heads, dh)).astype(
        np.float32)).to(card)
    valued = ops._valued(packs.fwd, e, heads)
    assert valued.w.shape == (heads, packs.fwd.nnz)
    got, launched = csr_spmm.write_mode("csr_spmm", valued, x,
                                        (None, mode))
    again, launched_again = csr_spmm.write_mode("csr_spmm", valued, x,
                                                (None, mode))
    assert launched and launched_again
    torch.cuda.synchronize()
    assert got.shape == (packs.fwd.n_rows, heads, dh)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    want = ref.csr_spmm_ref(valued, x)
    torch.testing.assert_close(got, want, **_csr_tol(want))
    for z in range(heads):
        one = csr_spmm.csr_spmm(ops._valued(packs.fwd, e[..., z]),
                                x[:, z].contiguous())
        torch.testing.assert_close(got[:, z], one, **_csr_tol(one))


@pytest.mark.parametrize("dh", [1, 6, 64, 100, 300])
def test_edge_dvals_heads_match_plain(card, dh):
    """``edge_dvals`` of ``g [n, 4, dh]`` and ``h [n, 4, dh]``: one launch
    for the 4 heads (in one pass where the row allows it, and head by
    head) against the plain version and against one launch a head, twice
    bit for bit, 0 at the padding edges."""
    from repro_torch.kernels import edge_spmm as kedge
    heads = 4
    src, dst, w = _edge_case(dh + 1)
    packs = ops.edge_packs(*(torch.as_tensor(a).to(card) for a in (
        src, dst, w)), 300, 500, long_row=16, grad=False)
    rng = np.random.default_rng(dh)
    h = torch.from_numpy(rng.normal(size=(3 * 500, heads, dh)).astype(
        np.float32)).to(card)
    g = torch.from_numpy(rng.normal(size=(3 * 300, heads, dh)).astype(
        np.float32)).to(card)
    n = kedge.edge_dvals.launches
    dv = [kedge.edge_dvals(packs.fwd, g, h, 3 * 6000) for _ in range(2)]
    torch.cuda.synchronize()
    assert kedge.edge_dvals.launches - n == 2
    assert dv[0].shape == (3 * 6000, heads)
    assert torch.equal(dv[0].view(torch.int32), dv[1].view(torch.int32))
    want = ref.edge_dvals_ref(packs.fwd, g, h, 3 * 6000)
    torch.testing.assert_close(dv[0], want, **ELL_TOL)
    assert not dv[0][torch.from_numpy(dst == 300).reshape(-1)].any()
    by_head = kedge._dvals(packs.fwd, g, h, 3 * 6000, one_pass=False)[0]
    torch.testing.assert_close(by_head, want, **ELL_TOL)
    for z in range(heads):
        one = kedge.edge_dvals(packs.fwd, g[:, z].contiguous(),
                               h[:, z].contiguous(), 3 * 6000)
        torch.testing.assert_close(dv[0][:, z], one, **ELL_TOL)


@pytest.mark.parametrize("heads", [1, 4])
def test_edge_spmm_at_heads_on_card_matches_cpu(card, heads):
    """``EdgeListAdj.spmm_at`` with ``e_vals [P, m, H]`` and ``h [P, n, H,
    64]`` (H = 4, and 1: GAT's ``num_heads=1``) on the card (one
    ``edge_spmm``, one ``edge_spmm_dh`` and one ``edge_dvals`` launch for
    the heads) against the CPU's loop over the heads: the output, ``d_h``
    and ``d_vals``."""
    from repro_torch.kernels import edge_spmm as kedge
    from repro_torch.models.gnn import EdgeListAdj
    src, dst, w = _edge_case(13)
    rng = np.random.default_rng(13)
    h0 = rng.normal(size=(3, 500, heads, 64)).astype(np.float32)
    g0 = rng.normal(size=(3, 300, heads, 64)).astype(np.float32)
    e0 = rng.normal(size=(3, 6000, heads)).astype(np.float32)
    res = {}
    for dev in ("cpu", card):
        s_, d_, w_ = (torch.as_tensor(a).to(dev) for a in (
            src.astype(np.int64), dst.astype(np.int64), w))
        adj = EdgeListAdj(s_, d_, w_, 300, 500,
                          ops.edge_packs(s_, d_, w_, 300, 500))
        h = torch.from_numpy(h0).to(dev).requires_grad_(True)
        e = torch.from_numpy(e0).to(dev).requires_grad_(True)
        n = [f.launches for f in (kedge.edge_spmm, kedge.edge_spmm_dh,
                                  kedge.edge_dvals)]
        out = adj.spmm_at(e, h)
        out.backward(torch.from_numpy(g0).to(dev))
        if dev == card:
            assert [f.launches - k for f, k in zip(
                (kedge.edge_spmm, kedge.edge_spmm_dh, kedge.edge_dvals),
                n)] == [1, 1, 1]
        res[str(dev)] = (out.detach().cpu(), h.grad.cpu(), e.grad.cpu())
    (oc, hc, ec), (og, hg, eg) = res["cpu"], res[str(card)]
    assert og.shape == (3, 300, heads, 64)
    torch.testing.assert_close(og, oc, **_csr_tol(oc))
    torch.testing.assert_close(hg, hc, **_csr_tol(hc))
    torch.testing.assert_close(eg, ec, **ELL_TOL)


def test_profiler_busy_is_kernels_with_ranges_open(card):
    """``launch.profile_serve``'s summary of a window whose kernels run
    inside nested ``device_scope`` ranges (and a copy): the busy time
    sums kernels, copies and memsets, so it stays within the wall time
    and the idle share is not negative; the ranges are listed apart."""
    from repro_torch.launch.profile_serve import _profiled, _summary
    from repro_torch.obs.annotations import device_scope
    a = torch.randn(2048, 2048, device=card)
    host = torch.randn(1 << 20)

    def window():
        with device_scope("outer"):
            for i in range(4):
                with device_scope(f"layer{i}/spmm"):
                    b = a @ a
                    b.add_(1.0)
            host.to(card)
    window()
    prof, wall = _profiled(window)
    rec = _summary("window", prof, wall)
    assert 0 < rec["device_busy_ms"] <= rec["wall_ms"]
    assert 0 <= rec["idle_share"] < 1
    assert {"outer", "layer0/spmm"} <= {r["op"] for r in rec["device_ranges"]}
    assert not {"outer", "layer0/spmm"} & {r["op"] for r in rec["device_top"]}


# GAT's edge softmax (csrc/edge_softmax.cu): both entry points against
# their plain versions, the autograd route against the CPU's


def _softmax_case(card, heads, long_row, seed=21):
    """The ``_edge_case`` packs on the card (long rows at ``long_row=16``,
    an empty row, padding edges) and per-node scores ``[P * n_cols, H]``."""
    src, dst, w = _edge_case(seed)
    packs = ops.edge_packs(*(torch.as_tensor(a).to(card) for a in (
        src, dst, w)), 300, 500, long_row=long_row)
    rng = np.random.default_rng(seed)
    es, ed = (torch.from_numpy(rng.normal(size=(3 * 500, heads)).astype(
        np.float32)).to(card) for _ in range(2))
    return packs, es, ed, rng


@pytest.mark.parametrize("long_row", [16, ops.LONG_ROW])
@pytest.mark.parametrize("heads", [1, 2, 3, 4, 8, 16])
def test_edge_softmax_kernels_match_plain(card, heads, long_row):
    """``edge_softmax_fwd`` and ``edge_softmax_bwd`` (GAT's 4 heads, every
    width the kernels are built for, and the masked width 3) against
    ``ref.edge_softmax_ref`` / ``ref.edge_softmax_bwd_ref`` over packs
    with long rows (over their segments) and an empty row: within 1e-5 of
    the largest magnitude, two launches of each bit for bit, the attention
    alone in ``A^T``'s order, and one count a call."""
    from repro_torch.kernels import edge_spmm as kedge
    packs, es, ed, rng = _softmax_case(card, heads, long_row)
    assert packs.fwd.long_rows.numel()
    assert packs.bwd.long_rows.numel() or long_row > 16
    nnz = packs.fwd.nnz
    n = [kedge.edge_softmax_fwd.launches, kedge.edge_softmax_bwd.launches]
    att = [kedge.edge_softmax_fwd(packs, es, ed) for _ in range(2)]
    d_att = torch.from_numpy(rng.normal(size=(heads, nnz)).astype(
        np.float32)).to(card)
    bwd = [kedge.edge_softmax_bwd(packs, att[0], es, ed, d_att)
           for _ in range(2)]
    only_t = kedge.edge_softmax_bwd(packs, att[0], es, ed)
    torch.cuda.synchronize()
    assert [kedge.edge_softmax_fwd.launches - n[0],
            kedge.edge_softmax_bwd.launches - n[1]] == [2, 3]
    assert att[0].shape == (heads, nnz)
    assert torch.equal(att[0].view(torch.int32), att[1].view(torch.int32))
    want = ref.edge_softmax_ref(packs.fwd, es, ed, 300, 500)
    torch.testing.assert_close(att[0], want, **_csr_tol(want))
    wants = ref.edge_softmax_bwd_ref(packs.fwd, packs.bwd, packs.amap,
                                     att[0], d_att, es, ed, 300, 500)
    for got, again, w_ in zip(bwd[0], bwd[1], wants):
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))
        torch.testing.assert_close(got, w_, **_csr_tol(w_))
    assert only_t[0] is None and only_t[1] is None
    assert torch.equal(only_t[2], att[0][:, packs.amap.long()])


# a row of each class of the grouping (CsrPack.runs: the least power of
# two >= its entries of lanes), and long rows over 2 and 40 segments
_CLASS_LENS = [0, 1, 2, 3, 4, 5, 8, 9, 16, 17, 32, 33, 256, 257]


def _class_case(card, long_row, heads, seed=25):
    """Packs on the card whose 2 partitions each hold one row of every
    length of :data:`_CLASS_LENS` and one of ``40 * long_row`` entries
    (rows shuffled, random columns, padding edges), and per-node scores
    ``[P * n_cols, H]``."""
    rng = np.random.default_rng(seed)
    lens = _CLASS_LENS + [40 * long_row]
    n_rows, n_cols, n_parts = len(lens), 700, 2
    m = sum(lens) + 9
    src = rng.integers(0, n_cols, (n_parts, m)).astype(np.int32)
    dst = np.full((n_parts, m), n_rows, np.int32)
    for p in range(n_parts):
        rows = rng.permutation(n_rows)
        dst[p, :m - 9] = np.repeat(rows, [lens[r] for r in rows])
    w = np.where(dst < n_rows, 1.0, 0.0).astype(np.float32)
    packs = ops.edge_packs(*(torch.as_tensor(a).to(card) for a in (
        src, dst, w)), n_rows, n_cols, long_row=long_row)
    es, ed = (torch.from_numpy(rng.normal(size=(n_parts * n_cols, heads))
                               .astype(np.float32)).to(card)
              for _ in range(2))
    return packs, es, ed, rng


@pytest.mark.parametrize("long_row", [16, ops.LONG_ROW])
@pytest.mark.parametrize("heads", [1, 2, 3, 4, 8, 16])
def test_edge_softmax_row_classes(card, heads, long_row):
    """Both softmax kernels over rows of 0, 1, 2, 3, 4, 5, 8, 9, 16, 17,
    32, 33, 256 and 257 entries (every boundary of the lanes a row) and a
    long row over 40 segments (at long_row 16 the rows past 16 are long
    too: 2 to 17 segments), against their plain versions within 1e-5 of
    the largest magnitude, each twice bit for bit."""
    from repro_torch.kernels import edge_spmm as kedge
    packs, es, ed, rng = _class_case(card, long_row, heads)
    n_seg = packs.fwd.long_seg_ptr[1:] - packs.fwd.long_seg_ptr[:-1]
    assert int(n_seg.max()) == 40 and int(n_seg.min()) == 2
    nnz = packs.fwd.nnz
    att = [kedge.edge_softmax_fwd(packs, es, ed) for _ in range(2)]
    d_att = torch.from_numpy(rng.normal(size=(heads, nnz)).astype(
        np.float32)).to(card)
    bwd = [kedge.edge_softmax_bwd(packs, att[0], es, ed, d_att)
           for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(att[0].view(torch.int32), att[1].view(torch.int32))
    want = ref.edge_softmax_ref(packs.fwd, es, ed, packs.n_rows,
                                packs.n_cols)
    torch.testing.assert_close(att[0], want, **_csr_tol(want))
    wants = ref.edge_softmax_bwd_ref(packs.fwd, packs.bwd, packs.amap,
                                     att[0], d_att, es, ed, packs.n_rows,
                                     packs.n_cols)
    for name, got, again, w_ in zip(("d_e_src", "d_e_dst", "att_t"), bwd[0],
                                    bwd[1], wants):
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))
        torch.testing.assert_close(got, w_, **_csr_tol(w_), msg=name)


@pytest.mark.parametrize("heads,dh", [(4, 64), (1, 64), (4, 1), (1, 1)])
def test_edge_attention_on_card_matches_cpu(card, heads, dh):
    """``ops.edge_attention`` (GAT's softmax and aggregation) on the card
    at the train cell's 4 heads of 64, at 1 head, and at head width 1
    (GAT's last layer): the output and the gradients of ``e_src``,
    ``e_dst`` and ``h`` against the CPU's plain route over the same packs;
    one launch of each kernel (``edge_softmax_fwd``, ``edge_spmm``,
    ``edge_dvals``, ``edge_softmax_bwd``, ``edge_spmm_dh``), and no
    per-call gather of the values."""
    from repro_torch.kernels import edge_spmm as kedge
    src, dst, w = _edge_case(22)
    rng = np.random.default_rng(22)
    es0, ed0 = (rng.normal(size=(3, 500, heads)).astype(np.float32)
                for _ in range(2))
    h0 = rng.normal(size=(3, 500, heads, dh)).astype(np.float32)
    g0 = rng.normal(size=(3, 300, heads, dh)).astype(np.float32)
    kernels = (kedge.edge_softmax_fwd, kedge.edge_spmm, kedge.edge_dvals,
               kedge.edge_softmax_bwd, kedge.edge_spmm_dh)
    res = {}
    for dev in ("cpu", card):
        packs = ops.edge_packs(*(torch.as_tensor(a).to(dev) for a in (
            src, dst, w)), 300, 500)
        ins = [torch.from_numpy(a).to(dev).requires_grad_(True)
               for a in (es0, ed0, h0)]
        n = [f.launches for f in kernels]
        gathers = ops._valued.gathers
        out = ops.edge_attention(*ins, packs)
        out.backward(torch.from_numpy(g0).to(dev))
        if dev == card:
            torch.cuda.synchronize()
            assert [f.launches - k for f, k in zip(kernels, n)] == [1] * 5
        assert ops._valued.gathers == gathers
        res[str(dev)] = [out.detach().cpu()] + [t.grad.cpu() for t in ins]
    for name, got, want in zip(("out", "d_e_src", "d_e_dst", "d_h"),
                               res[str(card)], res["cpu"]):
        assert got.shape == want.shape, name
        torch.testing.assert_close(got, want, **_csr_tol(want), msg=name)


def test_gat_layer_on_card_without_packs_raises(card):
    """GAT's layer over an edge list on the card without packs raises
    before any plain op runs there: the card has no softmax route but
    the packs'."""
    from repro_torch.models.gnn import EdgeListAdj, GNNConfig, _layer_apply
    from repro_torch.models.gnn import init_gnn
    src, dst, w = _edge_case(23)
    adj = EdgeListAdj(*(torch.as_tensor(a).to(card) for a in (
        src.astype(np.int64), dst.astype(np.int64), w)), 300, 500)
    cfg = GNNConfig(model="gat", in_dim=12, hidden_dim=16, out_dim=5)
    p = init_gnn(cfg, torch.Generator().manual_seed(0), card)[0]
    with pytest.raises(ValueError, match="needs the edge list's CSR packs"):
        _layer_apply(cfg, p, adj, torch.zeros(3, 500, 12, device=card), 300,
                     False)


def test_edge_dvals_in_pack_order(card):
    """``edge_dvals(..., a_order=True)`` (GAT's backward input, no perm
    read) is the edge-order result at ``perm``, head-major, bit for bit,
    for 4 heads of 64 (one pass) and of 6 (head by head)."""
    from repro_torch.kernels import edge_spmm as kedge
    src, dst, w = _edge_case(24)
    packs = ops.edge_packs(*(torch.as_tensor(a).to(card) for a in (
        src, dst, w)), 300, 500, long_row=16, grad=False)
    rng = np.random.default_rng(24)
    for dh in (64, 6):
        h = torch.from_numpy(rng.normal(size=(3 * 500, 4, dh)).astype(
            np.float32)).to(card)
        g = torch.from_numpy(rng.normal(size=(3 * 300, 4, dh)).astype(
            np.float32)).to(card)
        by_edge = kedge.edge_dvals(packs.fwd, g, h, 3 * 6000)
        in_order = kedge.edge_dvals(packs.fwd, g, h, 3 * 6000, a_order=True)
        torch.cuda.synchronize()
        assert in_order.shape == (4, packs.fwd.nnz)
        assert torch.equal(in_order, by_edge[packs.fwd.perm.long()].t())


# ---------------------------------------------------------------------------
# the transformer zoo's attention (csrc/flash_attn.cu, csrc/decode_attn.cu)
# ---------------------------------------------------------------------------

# f32: true f32 on both sides, sums in another order
ATTN_F32_TOL_OF_MAX = 1e-5
# bf16: the plain versions keep f32 and round each result once; the
# kernels' f32 results differ from theirs by far less than an ulp (P and
# dS as two bf16 parts, sums in another order), so an element may round
# one ulp apart: within 2^-7 of the larger of the two plus 2^-8 of the
# result's rms, and the mean |error| within 2^-13 of the mean |result|
ATTN_BF16_ULP = 2.0 ** -7
ATTN_BF16_FLOOR_OF_RMS = 2.0 ** -8
ATTN_BF16_MEAN_TOL = 2.0 ** -13

ATTN_CONFIGS = [(True, 0, 4, 2), (False, 0, 4, 4), (True, 50, 4, 1),
                (True, 0, 6, 2)]


def _attn_inputs(card, dtype, b, s, hq, hkv, dqk, dv, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(card, dtype)
            for shape in ((b, s, hq, dqk), (b, s, hkv, dqk),
                          (b, s, hkv, dv))]


def _close(got, want, tol: float, scale=None) -> float:
    want = want.float()
    scale = float(want.abs().max()) if scale is None else scale
    err = float((got.float() - want).abs().max())
    assert err <= tol * max(scale, 1e-30), (err, scale)
    return err


def _close_bf16(got, want) -> None:
    """The bf16 rule above, element by element and on the mean."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    bound = ATTN_BF16_ULP * torch.maximum(g.abs(), w.abs()) \
        + ATTN_BF16_FLOOR_OF_RMS * w.square().mean().sqrt()
    worst = float((d / bound.clamp_min(1e-30)).max())
    mean = float(d.sum() / w.abs().sum().clamp_min(1e-30))
    assert worst <= 1.0 and mean <= ATTN_BF16_MEAN_TOL, (worst, mean)


def _close_attn(got, want) -> None:
    """``got`` against the plain ``want`` by the rule of their dtype."""
    if want.dtype == torch.float32:
        _close(got, want, ATTN_F32_TOL_OF_MAX)
    else:
        _close_bf16(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("widths", [(32, 32), (48, 32), (64, 64), (96, 96),
                                    (128, 128), (192, 128)])
@pytest.mark.parametrize("config", ATTN_CONFIGS,
                         ids=["causal_gqa", "noncausal", "band_gqa4",
                              "causal_gqa3"])
def test_flash_attention_kernels_match_plain(card, dtype, widths, config):
    """The forward and both backward launches against the plain versions
    at every listed width (S = 200: three full 64-row tiles and a ragged
    one), twice bit for bit."""
    from repro_torch.kernels import flash_attn as fa
    causal, window, hq, hkv = config
    dqk, dv = widths
    q, k, v = _attn_inputs(card, dtype, 2, 200, hq, hkv, dqk, dv, seed=31)
    o, lse = fa.flash_attention_fwd(q, k, v, causal, window)
    o2, lse2 = fa.flash_attention_fwd(q, k, v, causal, window)
    want_o, want_lse = ref.flash_attention_ref(q, k, v, causal, window, 64, 64)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    _close_attn(o, want_o)
    _close(lse, want_lse, ATTN_F32_TOL_OF_MAX)
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(32)
                     ).to(card, dtype)
    dq, delta = fa.flash_attention_bwd_dq(do, q, k, v, o, lse, causal, window)
    dk, dvv = fa.flash_attention_bwd_dkdv(do, q, k, v, lse, delta, causal,
                                          window)
    dq2, _ = fa.flash_attention_bwd_dq(do, q, k, v, o, lse, causal, window)
    dk2, dv2 = fa.flash_attention_bwd_dkdv(do, q, k, v, lse, delta, causal,
                                           window)
    wants = ref.flash_attention_bwd_ref(do, q, k, v, o, lse, causal, window,
                                        64, 64)
    torch.cuda.synchronize()
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) and \
        torch.equal(dvv, dv2)
    _close(delta, (do.float() * o.float()).sum(-1).transpose(1, 2),
           ATTN_F32_TOL_OF_MAX)
    for got, want in zip((dq, dk, dvv), wants):
        assert got.shape == want.shape and got.dtype == dtype
        _close_attn(got, want)


# S about the backward's tiles (64 keys or queries a warpgroup, 32 queries a
# step at Dqk 192): one row, a tile less a row, a tile, two tiles and a
# row, ragged ones
FLASH_BWD_S = [1, 63, 64, 129, 200, 257]
FLASH_BWD_CONFIGS = [(True, 0), (False, 0), (True, 50)]
FLASH_BWD_GROUPS = [1, 2, 3, 4]


def _close_bf16_ties(got, want) -> None:
    """bf16 dv at S = 1: the one key has P = 1 up to the last bit of the
    recomputed score, and dv sums the group's dO rows, whose sum lands on
    a bf16 rounding tie for a large share of its elements; each side
    breaks those ties by its own last bit.  The element rule holds; the
    mean rule, whose power is against faults below an ulp spread over many
    elements (P's lo part, 0 here), has none at S = 1."""
    g, w = got.float(), want.float()
    bound = ATTN_BF16_ULP * torch.maximum(g.abs(), w.abs()) \
        + ATTN_BF16_FLOOR_OF_RMS * w.square().mean().sqrt()
    assert float(((g - w).abs() / bound.clamp_min(1e-30)).max()) <= 1.0


def _close_cancelled(got, want, terms: float) -> None:
    """A gradient that is exactly 0 (at S = 1 the one key gives dP =
    Delta, so dS = 0): each side holds only its own rounding of that
    cancellation, so both stay within one bf16 ulp (2^-7) of the size of
    the terms that cancel, ``terms``."""
    assert float(got.float().abs().max()) <= ATTN_BF16_ULP * terms
    assert float(want.float().abs().max()) <= ATTN_BF16_ULP * terms


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("widths", [(32, 32), (48, 32), (64, 64), (96, 96),
                                    (128, 128), (192, 128)])
@pytest.mark.parametrize("s", FLASH_BWD_S)
@pytest.mark.parametrize("config", FLASH_BWD_CONFIGS,
                         ids=["causal", "noncausal", "band50"])
def test_flash_attention_bwd_tiles_match_plain(card, dtype, widths, s,
                                               config):
    """The backward pair (``csrc/flash_attn_bwd.cu``: ``wgmma`` over TMA
    tiles in bf16) against the plain version at S about its tiles, B = 2,
    GQA groups of 1 to 4 over 2 KV heads, every width, causal, non-causal
    and banded, each twice bit for bit; the TMA's zero rows past S and
    the next batch row's must not leak into dk / dv."""
    from repro_torch.kernels import flash_attn as fa
    causal, window = config
    dqk, dv = widths
    hkv = 2
    for group in FLASH_BWD_GROUPS:
        q, k, v = _attn_inputs(card, dtype, 2, s, group * hkv, hkv, dqk, dv,
                               seed=36 + group)
        do = torch.randn((2, s, group * hkv, dv),
                         generator=torch.Generator().manual_seed(40 + group)
                         ).to(card, dtype)
        o, lse = fa.flash_attention_fwd(q, k, v, causal, window)
        dq, delta = fa.flash_attention_bwd_dq(do, q, k, v, o, lse, causal,
                                              window)
        dk, dvv = fa.flash_attention_bwd_dkdv(do, q, k, v, lse, delta, causal,
                                              window)
        dq2, delta2 = fa.flash_attention_bwd_dq(do, q, k, v, o, lse, causal,
                                                window)
        dk2, dv2 = fa.flash_attention_bwd_dkdv(do, q, k, v, lse, delta,
                                               causal, window)
        wants = ref.flash_attention_bwd_ref(do, q, k, v, o, lse, causal,
                                            window, 64, 64)
        torch.cuda.synchronize()
        case = (group, tuple(q.shape))
        assert torch.equal(dq, dq2) and torch.equal(delta, delta2), case
        assert torch.equal(dk, dk2) and torch.equal(dvv, dv2), case
        _close(delta, (do.float() * o.float()).sum(-1).transpose(1, 2),
               ATTN_F32_TOL_OF_MAX)
        for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dvv), wants):
            assert got.shape == want.shape and got.dtype == dtype, name
            if s == 1 and name != "dv":
                terms = float((do.float() * v.float().repeat_interleave(
                    group, 2)).abs().sum(-1).max())
                # dq sums one key's dS k, dk the group's dS q
                scale = float(ref.inv_sqrt(dqk)) * float(
                    (k if name == "dq" else q).float().abs().max()) * (
                    1 if name == "dq" else group)
                _close_cancelled(got, want, terms * scale)
            elif s == 1 and dtype == torch.bfloat16:
                _close_bf16_ties(got, want)
            else:
                _close_attn(got, want)


def _misaligned(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` as a view into a flat buffer at an odd element
    offset: contiguous, its storage 2 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.parametrize("widths", [(64, 64), (192, 128)])
def test_flash_attention_bwd_misaligned_operands(card, widths):
    """bf16 q, k, v, do and o that are views 2 bytes past a 16-byte
    boundary (the TMA reads only from 16-byte aligned addresses): the
    backward pair copies what its TMA reads and gives the same bits as on
    aligned copies of the same values."""
    from repro_torch.kernels import flash_attn as fa
    dqk, dv = widths
    q, k, v = _attn_inputs(card, torch.bfloat16, 2, 129, 4, 2, dqk, dv,
                           seed=44)
    do = torch.randn((2, 129, 4, dv), generator=torch.Generator(
    ).manual_seed(45)).to(card, torch.bfloat16)
    o, lse = fa.flash_attention_fwd(q, k, v)
    views = [_misaligned(x) for x in (q, k, v, do, o)]
    assert all(x.data_ptr() % 16 for x in views)
    mq, mk, mv, mdo, mo = views
    dq, delta = fa.flash_attention_bwd_dq(do, q, k, v, o, lse)
    dk, dvv = fa.flash_attention_bwd_dkdv(do, q, k, v, lse, delta)
    mdq, mdelta = fa.flash_attention_bwd_dq(mdo, mq, mk, mv, mo, lse)
    mdk, mdv = fa.flash_attention_bwd_dkdv(mdo, mq, mk, mv, lse, mdelta)
    torch.cuda.synchronize()
    assert torch.equal(dq, mdq) and torch.equal(delta, mdelta)
    assert torch.equal(dk, mdk) and torch.equal(dvv, mdv)


def _probe(name: str, argtypes):
    import ctypes
    from repro_torch.kernels import build
    fn = getattr(build.load("hopper_probe"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _swizzled(tile: torch.Tensor) -> torch.Tensor:
    """A tile [boxes, rows, 64] as the 128-byte swizzle stores it: the
    8-element chunk k of row r at chunk k ^ (r % 8)."""
    rows = tile.shape[1]
    col = torch.arange(64)
    out = torch.empty_like(tile)
    for r in range(rows):
        out[:, r, ((col // 8) ^ (r % 8)) * 8 + col % 8] = tile[:, r]
    return out


@pytest.mark.parametrize("d,rows,s0", [(32, 64, 0), (48, 64, 150),
                                       (96, 32, 190), (128, 64, 136),
                                       (192, 128, 100)])
def test_hopper_tma_tile_roundtrip(card, d, rows, s0):
    """One TMA tile of x [2, 200, 3, d] (hopper.cuh's ``tile_map``: boxes
    of [rows][64], 128-byte swizzle) into shared memory under an
    mbarrier, its bytes as stored, and a TMA store of it back: zeros past
    d and past S (not the next batch row), each row's chunks swizzled, the
    store writing only the tile's rows inside the tensor."""
    import ctypes
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _probe("hopper_probe_tma", [P] * 3 + [I] * 9 + [P])
    b, s, h = 2, 200, 3
    x = torch.randn((b, s, h, d), generator=torch.Generator().manual_seed(7)
                    ).to(card, torch.bfloat16)
    boxes = (d + 63) // 64
    back = torch.zeros_like(x)
    raw = torch.empty((boxes, rows, 64), dtype=torch.bfloat16, device=card)
    err = fn(x.data_ptr(), back.data_ptr(), raw.data_ptr(), b, s, h, d, rows,
             s0, 1, 1, card.index or 0,
             torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    tile = torch.zeros((rows, boxes * 64), dtype=torch.bfloat16)
    n = min(rows, s - s0)
    tile[:n, :d] = x[1, s0:s0 + n, 1].cpu()
    tile = tile.reshape(rows, boxes, 64).transpose(0, 1)
    assert torch.equal(raw.cpu(), _swizzled(tile))
    want = torch.zeros_like(x)
    want[1, s0:s0 + n, 1] = x[1, s0:s0 + n, 1]
    assert torch.equal(back, want)


@pytest.mark.parametrize("r,dt", [(64, 64), (64, 128), (64, 192), (32, 192),
                                  (32, 48)])
def test_hopper_wgmma_two_readings_of_one_tile(card, r, dt):
    """One bf16 tile t [r][dt] brought by TMA (a producer warpgroup after
    ``setmaxnreg`` down) and read by ``wgmma`` twice (a consumer
    warpgroup after ``setmaxnreg`` up): K-major as B of a1 t^T (A from
    shared memory, m64n{r}k16 over dt / 16 k-steps across its 64-column
    boxes) and MN-major as B of a2 t (A from registers, m64n64k16 a box),
    against ``torch.matmul`` of the same tiles in f32 (the products are
    exact, the sums in another order)."""
    import ctypes
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _probe("hopper_probe_wgmma", [P] * 5 + [I] * 3 + [P])
    g = torch.Generator().manual_seed(8)
    t, a1, a2 = (torch.randn(shape, generator=g).to(card, torch.bfloat16)
                 for shape in ((r, dt), (64, dt), (64, r)))
    boxes = (dt + 63) // 64
    c1 = torch.empty((64, r), device=card)
    c2 = torch.full((64, 64 * boxes), float("nan"), device=card)
    err = fn(t.data_ptr(), a1.data_ptr(), a2.data_ptr(), c1.data_ptr(),
             c2.data_ptr(), r, dt, card.index or 0,
             torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    _close(c1, a1.float() @ t.float().T, ATTN_F32_TOL_OF_MAX)
    _close(c2[:, :dt], a2.float() @ t.float(), ATTN_F32_TOL_OF_MAX)
    assert torch.equal(c2[:, dt:], torch.zeros_like(c2[:, dt:]))


def test_flash_attention_op_launches_on_card(card):
    """``blocked_attention`` / ``banded_attention`` on CUDA tensors go
    through the op: one forward launch, one of each backward launch, and
    the gradients of the CPU's plain route."""
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.models.transformer import attention as tatt
    q, k, v = _attn_inputs(card, torch.float32, 1, 130, 4, 2, 64, 64, 33)
    for fn in (lambda *x: tatt.blocked_attention(*x),
               lambda *x: tatt.banded_attention(*x, 40, chunk=32)):
        before = [w.launches for w in (fa.flash_attention_fwd,
                                       fa.flash_attention_bwd_dq,
                                       fa.flash_attention_bwd_dkdv)]
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*ts)
        grads = torch.autograd.grad(out.sum(), ts)
        cs = [t.detach().cpu().requires_grad_() for t in (q, k, v)]
        want = fn(*cs)
        wgrads = torch.autograd.grad(want.sum(), cs)
        after = [w.launches for w in (fa.flash_attention_fwd,
                                      fa.flash_attention_bwd_dq,
                                      fa.flash_attention_bwd_dkdv)]
        assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
        _close(out.cpu(), want.detach(), ATTN_F32_TOL_OF_MAX)
        for g, w in zip(grads, wgrads):
            _close(g.cpu(), w, ATTN_F32_TOL_OF_MAX)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
@pytest.mark.parametrize("group", [(16, 8), (4, 4), (25, 5), (12, 2)])
def test_decode_attention_kernel_matches_plain(card, dtype, d, group):
    """The decode kernel against its plain version over a ring mask with
    a batch row of no valid slot (the mean of V), twice bit for bit."""
    from repro_torch.kernels import flash_attn as fa
    hq, hkv = group
    b, w = 3, 256
    g = torch.Generator().manual_seed(34)
    q = torch.randn((b, 1, hq, d), generator=g).to(card, dtype)
    ck, cv = (torch.randn((b, w, hkv, d), generator=g).to(card, dtype)
              for _ in range(2))
    pos = torch.arange(w, device=card)
    valid = torch.stack([pos < 40, (pos >= 100) & (pos < 228),
                         torch.zeros_like(pos, dtype=torch.bool)])
    got = fa.decode_attention(q, ck, cv, valid)
    got2 = fa.decode_attention(q, ck, cv, valid)
    want = ref.decode_attention_ref(q, ck, cv, valid)
    torch.cuda.synchronize()
    assert torch.equal(got, got2)
    assert got.shape == q.shape and got.dtype == dtype
    _close_attn(got, want)


def test_attention_kernels_refuse_unlisted_operands(card):
    from repro_torch.kernels import flash_attn as fa
    q, k, v = _attn_inputs(card, torch.float32, 1, 70, 2, 2, 80, 80, 35)
    with pytest.raises(ValueError, match="not among"):
        fa.flash_attention_fwd(q, k, v)
    q, k, v = _attn_inputs(card, torch.float16, 1, 70, 2, 2, 64, 64, 35)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention_fwd(q, k, v)
    q, k, v = _attn_inputs(card, torch.float32, 1, 70, 2, 2, 64, 64, 35)
    with pytest.raises(ValueError, match="needs causal"):
        fa.flash_attention_fwd(q, k, v, False, 16)
    with pytest.raises(ValueError, match="not among"):
        fa.decode_attention(q[:, :1, :, :48], k[..., :48], v[..., :48],
                            torch.ones(1, 70, dtype=torch.bool, device=card))
    with pytest.raises(ValueError, match="at most"):
        fa.decode_attention(
            torch.zeros(1, 1, 9, 64, device=card), k[:, :, :1], v[:, :, :1],
            torch.ones(1, 70, dtype=torch.bool, device=card))


def test_traced_step_counts_equal_on_cuda_and_cpu_fakes(card):
    """A reduced config's ``loss_and_grads`` traced on fakes (the dry
    run's tracing): ``OpCounter``'s FLOPs and bytes equal on ``cuda`` and
    ``cpu`` fakes (the attention ops are one counted operation each)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_reduced
    from repro_torch.launch.hlo_cost import OpCounter
    from repro_torch.models.transformer import init_model, loss_and_grads
    from repro_torch.optim.optimizers import tree_map
    costs = {}
    for arch in ("qwen3-1.7b", "deepseek-v3-671b", "mixtral-8x7b"):
        cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
        shapes = init_model(cfg, None, device="meta")
        for dev in ("cuda", "cpu"):
            with FakeTensorMode():
                params = tree_map(lambda t: torch.empty(
                    t.shape, dtype=t.dtype, device=dev), shapes)
                data = {key: torch.zeros((2, 96), dtype=torch.int64,
                                         device=dev)
                        for key in ("tokens", "labels")}
                with OpCounter() as counter:
                    loss_and_grads(cfg, params, data)
            costs[arch, dev] = (counter.cost.flops,
                                counter.cost.bytes_accessed)
        assert costs[arch, "cuda"] == costs[arch, "cpu"], arch
