"""Blocked-ELL SpMM on the card: the wrappers of ``csrc/ell_spmm.cu`` and
``csrc/ell_spmm_bwd.cu``, and the autograd Function over them.

- :func:`ell_spmm` — the forward kernel, f32 or bf16 ``h`` (f32 sums,
  output in ``h``'s type); it replaces the JAX package's Pallas TPU kernel
  ``_ell_spmm_raw`` (``src/repro/kernels/ell_spmm.py``);
- :func:`ell_spmm_chunked` — the same product walked in ``col_chunk``-row
  chunks of ``h``, replacing that kernel's ``chunk_kernel`` (the same
  CUDA kernel with chunks);
- :func:`ell_spmm_dh` and :func:`ell_spmm_dvals` — the backward kernels,
  replacing the custom VJP's ``_spmm_vjp.bwd`` (a jnp scatter and einsum
  in the JAX package);
- :class:`EllSpmmFn` — the differentiable product: the kernels for CUDA
  tensors, the plain versions of :mod:`.ref` for CPU tensors;
- :func:`ell_launch_config` — the forward kernel's vector width and
  stripe for a row width, chosen on the host.

The forward takes an optional ``row_end`` ``[P, n_rows]`` int32, one past
each row's last live slot (:func:`~.ops.ell_row_end` of the constant
pack): the kernel reads no slot past it.  Without it every slot is read.
The bound holds only while ``vals`` stays as it was: :class:`EllSpmmFn`
refuses ``row_end`` when ``vals`` needs a gradient.

The sources say what bounds each kernel on the H100 and what the design
does about it.  Each wrapper checks its operands, launches on the current
stream of the operands' device without synchronising, raises if the
launch fails, and adds one to its ``launches`` counter per launch.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from . import ref as _ref

__all__ = ["ell_spmm", "ell_spmm_chunked", "ell_spmm_dh", "ell_spmm_dvals",
           "EllSpmmFn", "ell_launch_config"]

_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# backward: (cols, vals|g, in, out, n_parts, n_rows, k, n_cols, d,
#            strides x3, device, stream)
_ARGTYPES = [_PTR] * 4 + [_INT] * 5 + [_I64] * 3 + [_INT, _PTR]
# forward: (cols, vals, row_end, h, out, n_parts, n_rows, k, n_cols, d,
#           col_chunk, strides x3, vec, stripe_vectors, device, stream)
_FWD_ARGTYPES = [_PTR] * 5 + [_INT] * 6 + [_I64] * 3 + [_INT] * 3 + [_PTR]
_FLOAT_TYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}

# The forward kernel's feature stripe, the fastest on the H100 over the main
# paths' launches (PERF.md: chip_smoke.py --sweep): each warp covers a
# stripe of this many bytes of an h row (four stripes of a 500-wide f32
# row, 35 MB of h per stripe on the serving pack).
STRIPE_BYTES = 512
STRIPE_VECTORS = (16, 32, 64, 128)   # the widths csrc/ell_spmm.cu builds

_FNS: dict = {}


def _entry(lib: str, name: str, argtypes):
    """The C entry point ``name`` of ``csrc/<lib>.cu``, built and loaded at
    first use."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(build.load(lib), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _launch(fn, device: int, *args) -> None:
    """``fn(*args, device, stream)`` on ``device``'s current stream; the C
    entry point switches to ``device`` only if the caller is on another."""
    err = fn(*args, device, torch._C._cuda_getCurrentRawStream(device))
    if err:
        raise RuntimeError(f"{fn.__name__} kernel launch failed with CUDA "
                           f"error {err}")


def ell_launch_config(d: int, elem_bytes: int,
                      addr_bits: int) -> tuple[int, int]:
    """``(vec, stripe_vectors)`` of the forward kernel for h rows of
    ``d`` elements of ``elem_bytes`` bytes.

    ``vec`` elements make the widest load (16, 8, 4 or 2 bytes, at least
    one element) that divides the row's bytes and ``addr_bits``, the OR of
    the h and out base addresses.  A warp's stripe is ``stripe_vectors``
    such loads wide: :data:`STRIPE_BYTES`, within the widths the kernel is
    built for, and no wider than the row needs.
    """
    vec_bytes = 16
    while vec_bytes > elem_bytes and (d * elem_bytes % vec_bytes
                                      or addr_bits % vec_bytes):
        vec_bytes //= 2
    n_vec = d * elem_bytes // vec_bytes
    stripe = STRIPE_VECTORS[0]
    for width in STRIPE_VECTORS[1:]:
        if width * vec_bytes > STRIPE_BYTES or stripe >= n_vec:
            break
        stripe = width
    return vec_bytes // elem_bytes, stripe


def _check(kernel: str, named: dict, dev: torch.device) -> None:
    for name, t in named.items():
        if t.device.type != "cuda":
            raise ValueError(f"{kernel} kernel: {name} is on {t.device}, "
                             "not on a CUDA device")
        if t.device != dev:
            raise ValueError(f"{kernel} kernel: {name} is on {t.device} "
                             f"but the operands are on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel} kernel: {name} must be contiguous")


def _check_pack(kernel: str, cols: torch.Tensor, vals: torch.Tensor | None,
                dense: torch.Tensor, dense_name: str,
                dense_rows_match: bool) -> None:
    """cols (vals) ``[P, n_rows, K]`` and a dense operand ``[P, ., d]``."""
    if cols.dtype != torch.int32:
        raise TypeError(f"{kernel} kernel: cols must be int32, "
                        f"got {cols.dtype}")
    if vals is not None and vals.dtype != torch.float32:
        raise TypeError(f"{kernel} kernel: vals must be float32, "
                        f"got {vals.dtype}")
    shapes_ok = (cols.dim() == 3 and dense.dim() == 3
                 and cols.shape[0] == dense.shape[0]
                 and (vals is None or vals.shape == cols.shape)
                 and (not dense_rows_match or dense.shape[1] == cols.shape[1]))
    if not shapes_ok:
        got = [tuple(cols.shape)] + ([] if vals is None
                                     else [tuple(vals.shape)])
        raise ValueError(f"{kernel} kernel: cols/vals [P, n_rows, K] and "
                         f"{dense_name} [P, ., d] expected, got {got} and "
                         f"{tuple(dense.shape)}")
    if cols.shape[0] > 65535:   # the partition is the grid's z dimension
        raise ValueError(f"{kernel} kernel: at most 65535 partitions per "
                         f"launch, got {cols.shape[0]}")


def _stacked(*ts):
    """2-D operands as a stack of one partition."""
    return tuple(t[None] for t in ts)


def _forward(cols, vals, h, col_chunk, row_end):
    """The forward launch; returns ``(out, launched)``."""
    kernel = "ell_spmm" if col_chunk is None else "ell_spmm_chunked"
    batched = h.dim() == 3
    if not batched:
        cols, vals, h = _stacked(cols, vals, h)
        if row_end is not None:
            row_end = row_end[None]
    named = {"cols": cols, "vals": vals, "h": h}
    if row_end is not None:
        named["row_end"] = row_end
    _check(kernel, named, h.device)
    _check_pack(kernel, cols, vals, h, "h", dense_rows_match=False)
    if h.dtype not in _FLOAT_TYPES:
        raise TypeError(f"{kernel} kernel: h must be float32 or bfloat16, "
                        f"got {h.dtype}")
    if row_end is not None and (row_end.dtype != torch.int32
                                or row_end.shape != cols.shape[:2]):
        raise TypeError(f"{kernel} kernel: row_end must be int32 "
                        f"{tuple(cols.shape[:2])}, got {row_end.dtype} "
                        f"{tuple(row_end.shape)}")
    n_parts, n_rows, k = cols.shape
    n_cols, d = h.shape[1], h.shape[2]
    out = torch.empty((n_parts, n_rows, d), dtype=h.dtype, device=h.device)
    launched = bool(out.numel())
    if launched:
        vec, stripe = ell_launch_config(d, h.element_size(),
                                        h.data_ptr() | out.data_ptr())
        fn = _entry("ell_spmm", f"ell_spmm_{_FLOAT_TYPES[h.dtype]}",
                    _FWD_ARGTYPES)
        _launch(fn, h.get_device(), cols.data_ptr(), vals.data_ptr(),
                None if row_end is None else row_end.data_ptr(),
                h.data_ptr(), out.data_ptr(), n_parts, n_rows, k, n_cols, d,
                col_chunk or n_cols, n_rows * k, n_cols * d, n_rows * d,
                vec, stripe)
    return (out if batched else out[0]), launched


def ell_spmm(cols: torch.Tensor, vals: torch.Tensor, h: torch.Tensor,
             row_end: torch.Tensor | None = None) -> torch.Tensor:
    """``out[..., i, :] = sum_k vals[..., i, k] * h[..., cols[..., i, k], :]``
    on the card, for one graph (2-D operands) or a stack of P partitions
    (``cols``/``vals`` ``[P, n_rows, K]``, ``h`` ``[P, n_cols, d]``, one
    launch).  ``h`` is f32 or bf16; sums are f32 and the output has
    ``h``'s type.  Padding slots carry ``vals == 0``; ``row_end`` (see the
    module) bounds the slots read.  Not differentiable (see
    :class:`EllSpmmFn`)."""
    out, launched = _forward(cols, vals, h, None, row_end)
    ell_spmm.launches += int(launched)
    return out


def ell_spmm_chunked(cols: torch.Tensor, vals: torch.Tensor,
                     h: torch.Tensor, col_chunk: int,
                     row_end: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`ell_spmm` with the h rows walked in chunks of ``col_chunk``,
    each chunk accumulating only the slots whose column lies in it (the
    TPU kernel's ``chunk_kernel``).  The same product; only the order of
    the f32 sums differs."""
    if col_chunk < 1:
        raise ValueError(f"ell_spmm_chunked kernel: col_chunk must be >= 1, "
                         f"got {col_chunk}")
    col_chunk = min(int(col_chunk), max(h.shape[-2], 1))
    out, launched = _forward(cols, vals, h, col_chunk, row_end)
    ell_spmm_chunked.launches += int(launched)
    return out


def ell_spmm_dh(cols: torch.Tensor, vals: torch.Tensor, g: torch.Tensor,
                n_cols: int) -> torch.Tensor:
    """``d_h = A^T g``: ``d_h[..., c, :] = sum vals[..., i, k] * g[..., i, :]``
    over the slots with ``cols[..., i, k] == c``, f32, ``[..., n_cols, d]``.
    Atomic sums: the result is not bit-reproducible run to run."""
    batched = g.dim() == 3
    if not batched:
        cols, vals, g = _stacked(cols, vals, g)
    _check("ell_spmm_dh", {"cols": cols, "vals": vals, "g": g}, g.device)
    _check_pack("ell_spmm_dh", cols, vals, g, "g", dense_rows_match=True)
    if g.dtype != torch.float32:
        raise TypeError(f"ell_spmm_dh kernel: g must be float32, "
                        f"got {g.dtype}")
    n_parts, n_rows, k = cols.shape
    d = g.shape[2]
    dh = torch.zeros((n_parts, n_cols, d), dtype=torch.float32,
                     device=g.device)
    if n_rows * k and d and n_cols:
        fn = _entry("ell_spmm_bwd", "ell_spmm_dh_f32", _ARGTYPES)
        _launch(fn, g.get_device(), cols.data_ptr(), vals.data_ptr(),
                g.data_ptr(), dh.data_ptr(), n_parts, n_rows, k, n_cols, d,
                n_rows * k, n_rows * d, n_cols * d)
        ell_spmm_dh.launches += 1
    return dh if batched else dh[0]


def ell_spmm_dvals(cols: torch.Tensor, g: torch.Tensor,
                   h: torch.Tensor) -> torch.Tensor:
    """``d_vals[..., i, k] = <g[..., i, :], h[..., cols[..., i, k], :]>`` for
    every slot (padding slots included, as the reference's einsum), f32,
    ``[..., n_rows, K]``."""
    batched = g.dim() == 3
    if not batched:
        cols, g, h = _stacked(cols, g, h)
    _check("ell_spmm_dvals", {"cols": cols, "g": g, "h": h}, g.device)
    _check_pack("ell_spmm_dvals", cols, None, g, "g", dense_rows_match=True)
    if g.dtype != torch.float32 or h.dtype != torch.float32 \
            or h.dim() != 3 or h.shape[0] != g.shape[0] \
            or h.shape[2] != g.shape[2]:
        raise TypeError(f"ell_spmm_dvals kernel: g [P, n_rows, d] and h "
                        f"[P, n_cols, d] float32 expected, got {g.dtype} "
                        f"{tuple(g.shape)} and {h.dtype} {tuple(h.shape)}")
    n_parts, n_rows, k = cols.shape
    n_cols, d = h.shape[1], h.shape[2]
    dvals = torch.empty((n_parts, n_rows, k), dtype=torch.float32,
                        device=g.device)
    if dvals.numel():
        fn = _entry("ell_spmm_bwd", "ell_spmm_dvals_f32", _ARGTYPES)
        _launch(fn, g.get_device(), cols.data_ptr(), g.data_ptr(),
                h.data_ptr(), dvals.data_ptr(), n_parts, n_rows, k, n_cols,
                d, n_rows * k, n_rows * d, n_cols * d)
        ell_spmm_dvals.launches += 1
    return dvals if batched else dvals[0]


for _fn in (ell_spmm, ell_spmm_chunked, ell_spmm_dh, ell_spmm_dvals):
    _fn.launches = 0


class EllSpmmFn(torch.autograd.Function):
    """Differentiable blocked-ELL SpMM, ``EllSpmmFn.apply(cols, vals, h,
    col_chunk, row_end)``, for 2-D operands or a ``[P, ...]`` stack.

    Dispatch goes by the device of ``h``: the CUDA kernels for CUDA
    tensors, the plain versions of :mod:`.ref` for CPU tensors.  The
    backward mirrors the JAX package's ``_spmm_vjp.bwd``: ``d_h = A^T g``
    and ``d_vals[i, k] = <g[i], h[cols[i, k]]>``, each computed only when
    ``ctx.needs_input_grad`` asks for it, cast to the input's dtype; the
    ``cols`` cotangent is ``None``.  ``row_end`` only bounds the slots the
    forward kernel reads; the plain versions need no bound.  It is computed
    once from constant ``vals``, so it is refused (``ValueError``, on both
    devices) when ``vals`` needs a gradient: a trained padding slot past it
    would be skipped on the card and counted on the CPU.
    """

    @staticmethod
    def forward(ctx, cols, vals, h, col_chunk=None, row_end=None):
        if row_end is not None and ctx.needs_input_grad[1]:
            raise ValueError("ell_spmm: row_end bounds the slots of constant "
                             "vals; pass no row_end when vals needs a "
                             "gradient")
        # h is needed only for d_vals: a training step whose vals are
        # constants keeps no layer input alive for the backward
        ctx.save_for_backward(cols, vals,
                              h if ctx.needs_input_grad[1] else None)
        ctx.h_meta = (h.shape[-2], h.dtype)
        if h.device.type == "cpu":
            if col_chunk is None:
                return _ref.ell_spmm_ref(cols, vals, h)
            return _ref.ell_spmm_chunked_ref(cols, vals, h, col_chunk)
        if col_chunk is None:
            return ell_spmm(cols, vals, h, row_end)
        return ell_spmm_chunked(cols, vals, h, col_chunk, row_end)

    @staticmethod
    def backward(ctx, g):
        cols, vals, h = ctx.saved_tensors
        n_cols, h_dtype = ctx.h_meta
        need_vals, need_h = ctx.needs_input_grad[1], ctx.needs_input_grad[2]
        g32 = g.float().contiguous()
        if g.device.type == "cpu":
            d_vals, d_h = _ref.ell_spmm_bwd_ref(cols, vals, h, g32, n_cols,
                                                need_vals, need_h)
        else:
            d_vals = (ell_spmm_dvals(cols, g32, h.float().contiguous())
                      if need_vals else None)
            d_h = (ell_spmm_dh(cols, vals, g32, n_cols) if need_h else None)
        if d_vals is not None:
            d_vals = d_vals.to(vals.dtype)
        if d_h is not None:
            d_h = d_h.to(h_dtype)
        return None, d_vals, d_h, None, None
