"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: the kernels have no CPU mode, so these tests need an
NVIDIA GPU with ``nvcc`` and skip without one.  On a GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

ELL SpMM agrees with the plain loop within atol 1e-4 / rtol 1e-5 (f32 sums
in another order); the row gather is bit-exact.
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
