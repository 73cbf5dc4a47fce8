"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: the kernels have no CPU mode, so these tests need an
NVIDIA GPU with ``nvcc`` and skip without one.  On a GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

ELL SpMM, its chunked variant and its two backward kernels agree with
the plain versions within atol 1e-4 / rtol 1e-5 (f32 sums in another
order; the ``d_h`` kernel's atomics in an order that changes from run to
run); bf16 ELL SpMM within one bf16 rounding of the output (rtol/atol
1e-2); the row gather is bit-exact.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import cache_gather, ell_spmm, ops, ref

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
    with pytest.raises(ValueError, match="multiple of col_chunk"):
        ops.ell_spmm(cols, vals, h, col_chunk=nc - 1)


@pytest.mark.parametrize("p,n,k,nc,d", [
    (1, 70, 5, 90, 48), (3, 33, 37, 50, 7), (2, 300, 144, 500, 500),
    (2, 100, 20, 300, 700), (4, 129, 1, 64, 256), (1, 31, 33, 40, 1)])
def test_backward_kernels_match_plain(card, p, n, k, nc, d):
    cols, vals, h = (t.to(card) for t in _ell(p * n + d + 1, p, n, k, nc, d))
    g = torch.randn((p, n, d), generator=torch.Generator(device=card)
                    .manual_seed(d), device=card)
    b_dh, b_dv = ell_spmm.ell_spmm_dh.launches, ell_spmm.ell_spmm_dvals.launches
    dh = ell_spmm.ell_spmm_dh(cols, vals, g, nc)
    dv = ell_spmm.ell_spmm_dvals(cols, g, h)
    want_dv, want_dh = ref.ell_spmm_bwd_ref(cols, vals, h, g, nc)
    torch.cuda.synchronize()
    assert ell_spmm.ell_spmm_dh.launches == b_dh + 1
    assert ell_spmm.ell_spmm_dvals.launches == b_dv + 1
    torch.testing.assert_close(dh, want_dh, **ELL_TOL)
    torch.testing.assert_close(dv, want_dv, **ELL_TOL)
    # one partition, unstacked 2-D operands
    torch.testing.assert_close(ell_spmm.ell_spmm_dh(cols[0], vals[0], g[0], nc),
                               want_dh[0], **ELL_TOL)
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
    want = ops.hybrid_spmm(cols, vals, ts, td, tw, h)
    got = ops.hybrid_spmm(*(t.to(card) for t in (cols, vals, ts, td, tw, h)))
    torch.testing.assert_close(got.cpu(), want, **ELL_TOL)


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


def test_serve_slice_on_card_matches_cpu(card):
    """The serving slice at a small size: the card's precompute tables
    equal the CPU's (same parameters) within 1e-5, and the served stream's
    counts are equal."""
    from repro_torch.launch.serve import build_parser, serve_gnn

    argv = ["gnn", "--scale", "0.02", "--feat-dim", "32", "--hidden", "32",
            "--backend", "hybrid", "--queries", "300", "--qps", "2000"]
    rep_gpu, eng_gpu = serve_gnn(build_parser().parse_args(
        argv + ["--device", "cuda"]))
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
    the counts exactly; each step launches the ELL forward 3 times, the
    ``d_h`` kernel twice (layers 1 and 2) and ``d_vals`` never."""
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
        counts = (ell_spmm.ell_spmm.launches, ell_spmm.ell_spmm_dh.launches,
                  ell_spmm.ell_spmm_dvals.launches)
        _, reps[dev] = train_capgnn(
            cfg, rt, xplan, args.parts, sgd(0.5), epochs=8,
            controller=StalenessController(refresh_every=4), spec=spec)
        torch.cuda.synchronize()
        got = (ell_spmm.ell_spmm.launches - counts[0],
               ell_spmm.ell_spmm_dh.launches - counts[1],
               ell_spmm.ell_spmm_dvals.launches - counts[2])
        assert got == ((0, 0, 0) if dev == "cpu" else (24, 16, 0)), dev
    np.testing.assert_allclose(reps["cuda"].losses, reps["cpu"].losses,
                               rtol=0, atol=1e-5)
    for k in ("comm_bytes", "comm_bytes_vanilla", "refresh_steps",
              "cached_steps", "step_kinds"):
        assert getattr(reps["cuda"], k) == getattr(reps["cpu"], k), k
