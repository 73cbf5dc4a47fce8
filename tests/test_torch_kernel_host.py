"""The host side of the port's CUDA kernels, on the CPU: the ELL forward's
launch configuration (vector width, stripe) chosen in Python, the per-row
slot bound ``row_end`` computed from the constant pack, its way from the
stacked layout to the kernel, and its refusal where ``vals`` is trained.  The kernels themselves run
only on the card (``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ell_spmm as kell
from repro_torch.kernels import ops

# (d, element bytes) of the main paths: h at d = 500 (layer 0) and 256
# (layers 1-2) in f32, and the bf16 forward at d = 500; then ragged widths
MAIN_WIDTHS = [(500, 4), (256, 4), (500, 2)]
RAGGED_WIDTHS = [(4, 4), (7, 4), (7, 2), (128, 2), (130, 4), (130, 2),
                 (256, 2), (499, 4), (499, 2), (700, 4), (1, 2)]


def _vec_bytes_ok(d, elem, addr, vec_bytes):
    return d * elem % vec_bytes == 0 and addr % vec_bytes == 0


# base-address bits: aligned, and off by 8, 4 or 2 bytes (a tensor's
# address is a multiple of its element size)
CASES = [(d, elem, addr) for d, elem in MAIN_WIDTHS + RAGGED_WIDTHS
         for addr in (0, 256, 8, 4, 2) if addr % elem == 0]


@pytest.mark.parametrize("d,elem,addr", CASES)
def test_ell_launch_config_is_valid_and_widest(d, elem, addr):
    """The load is the widest of 16, 8, 4, 2 bytes (at least one element)
    that divides the row's bytes and the base addresses; the stripe is one
    the kernel is built for, within STRIPE_BYTES unless the narrowest is
    wider, and no wider than the row needs."""
    vec, stripe = kell.ell_launch_config(d, elem, addr)
    vec_bytes = vec * elem
    assert vec >= 1 and d % vec == 0 and vec_bytes <= 16
    assert _vec_bytes_ok(d, elem, addr, vec_bytes)
    wider = [b for b in (16, 8, 4, 2) if b > vec_bytes and b > elem]
    assert not any(_vec_bytes_ok(d, elem, addr, b) for b in wider)
    assert stripe in kell.STRIPE_VECTORS
    n_vec = d // vec
    narrowest = kell.STRIPE_VECTORS[0]
    assert stripe == narrowest or stripe * vec_bytes <= kell.STRIPE_BYTES
    assert stripe == narrowest or stripe // 2 < n_vec


@pytest.mark.parametrize("d,elem,vec_bytes", [(500, 4, 16), (256, 4, 16),
                                              (500, 2, 8), (256, 2, 16),
                                              (130, 4, 8), (499, 4, 4),
                                              (7, 2, 2)])
def test_ell_launch_config_vector_width(d, elem, vec_bytes):
    """16-byte loads for f32 at d = 500 and 256, 8-byte for bf16 at
    d = 500 (1000-byte rows), narrower at the ragged widths."""
    vec, _ = kell.ell_launch_config(d, elem, 0)
    assert vec * elem == vec_bytes


def _row_end_loop(vals):
    out = np.zeros(vals.shape[:-1], np.int32)
    for idx in np.ndindex(*vals.shape[:-1]):
        live = np.flatnonzero(vals[idx])
        out[idx] = live[-1] + 1 if live.size else 0
    return out


@pytest.mark.parametrize("seed,pad", [(0, 0.0), (1, 0.5), (2, 0.95),
                                      (3, 1.0)])
def test_ell_row_end_matches_a_loop(seed, pad):
    """Any slot order: live slots after padding, rows with none."""
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(3, 40, 37)).astype(np.float32)
    vals[rng.random(vals.shape) < pad] = 0.0
    vals[0, 5] = 0.0
    vals[1, 6, :36] = 0.0            # only the last slot is live
    got = ops.ell_row_end(vals)
    assert got.dtype == np.int32 and got.shape == (3, 40)
    np.testing.assert_array_equal(got, _row_end_loop(vals))
    np.testing.assert_array_equal(ops.ell_row_end(vals[2]),
                                  _row_end_loop(vals[2]))


def test_ell_row_end_changes_nothing_on_the_cpu():
    """The plain path takes ``row_end`` and ignores it: the same product
    and gradients, chunked or not."""
    rng = np.random.default_rng(7)
    cols = torch.from_numpy(rng.integers(0, 30, (2, 20, 9)).astype(np.int32))
    vals = rng.normal(size=(2, 20, 9)).astype(np.float32)
    vals[rng.random(vals.shape) < 0.6] = 0.0
    row_end = torch.from_numpy(ops.ell_row_end(vals))
    vals = torch.from_numpy(vals)
    h = torch.from_numpy(rng.normal(size=(2, 30, 6)).astype(np.float32))
    for chunk in (None, 10):
        x0 = h.clone().requires_grad_(True)
        x1 = h.clone().requires_grad_(True)
        a = ops.ell_spmm(cols, vals, x0, col_chunk=chunk)
        b = ops.ell_spmm(cols, vals, x1, col_chunk=chunk, row_end=row_end)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        a.sum().backward()
        b.sum().backward()
        torch.testing.assert_close(x0.grad, x1.grad, rtol=0, atol=0)


@pytest.mark.parametrize("chunk", [None, 10])
def test_ell_row_end_refused_when_vals_need_a_gradient(chunk):
    """``row_end`` is a bound of constant ``vals``: with ``vals`` that
    need a gradient it is refused (a trained padding slot past it would be
    skipped on the card); without it the product is differentiable in
    ``vals``."""
    rng = np.random.default_rng(11)
    cols = torch.from_numpy(rng.integers(0, 30, (2, 20, 9)).astype(np.int32))
    vals = rng.normal(size=(2, 20, 9)).astype(np.float32)
    vals[rng.random(vals.shape) < 0.6] = 0.0
    row_end = torch.from_numpy(ops.ell_row_end(vals))
    vals = torch.from_numpy(vals).requires_grad_(True)
    h = torch.from_numpy(rng.normal(size=(2, 30, 6)).astype(np.float32))
    with pytest.raises(ValueError, match="row_end"):
        ops.ell_spmm(cols, vals, h, col_chunk=chunk, row_end=row_end)
    ops.ell_spmm(cols, vals, h, col_chunk=chunk).sum().backward()
    assert vals.grad is not None and vals.grad.shape == vals.shape


@pytest.mark.parametrize("backend", ["ell", "hybrid"])
def test_adj_builder_carries_row_end(backend):
    """The stacked layout's adjacency hands the kernel the pack's
    ``row_end``, computed once where the pack goes to the device."""
    from repro_torch.dist import make_adj_builder
    from repro_torch.launch.train import build_parser, prepare_train

    args = build_parser().parse_args(
        ["gnn", "--device", "cpu", "--scale", "0.01", "--feat-dim", "16",
         "--hidden", "16", "--backend", backend, "--epochs", "1"])
    sp = prepare_train(args)["sp"]
    leaves, build = make_adj_builder(sp, backend)
    adj = build(leaves)
    assert adj.row_end is leaves["row_end"]
    assert adj.row_end.dtype == torch.int32
    np.testing.assert_array_equal(adj.row_end.numpy(),
                                  _row_end_loop(np.asarray(sp.ell.vals)))
