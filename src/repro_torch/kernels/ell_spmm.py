"""Blocked-ELL SpMM on the card: the wrapper of ``csrc/ell_spmm.cu``.

The kernel replaces the JAX package's Pallas TPU kernel ``_ell_spmm_raw``
(``src/repro/kernels/ell_spmm.py``); its source says what bounds it on the
H100 and what the design does about that.  This wrapper only launches:
the CPU path and the dispatch by device live in :mod:`.ops`, the plain
version in :mod:`.ref`.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = ["ell_spmm"]

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])


_FN = None


def _entry():
    """The kernel's C entry point, built and loaded at first use."""
    global _FN
    if _FN is None:
        fn = build.load("ell_spmm").ell_spmm_f32
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(cols: torch.Tensor, vals: torch.Tensor, h: torch.Tensor) -> None:
    for name, t in (("cols", cols), ("vals", vals), ("h", h)):
        if t.device.type != "cuda":
            raise ValueError(f"ell_spmm kernel: {name} is on {t.device}, "
                             "not on a CUDA device")
        if t.device != h.device:
            raise ValueError(f"ell_spmm kernel: {name} is on {t.device} "
                             f"but h is on {h.device}")
        if not t.is_contiguous():
            raise ValueError(f"ell_spmm kernel: {name} must be contiguous")
    if cols.dtype != torch.int32:
        raise TypeError(f"ell_spmm kernel: cols must be int32, "
                        f"got {cols.dtype}")
    if vals.dtype != torch.float32 or h.dtype != torch.float32:
        raise TypeError("ell_spmm kernel: vals and h must be float32 (the "
                        f"bf16-h variant is not ported), got {vals.dtype} "
                        f"and {h.dtype}")
    if cols.shape != vals.shape or cols.dim() != 3 or h.dim() != 3 \
            or cols.shape[0] != h.shape[0]:
        raise ValueError(f"ell_spmm kernel: cols/vals [P, n_rows, K] and h "
                         f"[P, n_cols, d] expected, got {tuple(cols.shape)}, "
                         f"{tuple(vals.shape)} and {tuple(h.shape)}")
    if cols.shape[0] > 65535:   # the partition is the grid's z dimension
        raise ValueError(f"ell_spmm kernel: at most 65535 partitions per "
                         f"launch, got {cols.shape[0]}")


def ell_spmm(cols: torch.Tensor, vals: torch.Tensor,
             h: torch.Tensor) -> torch.Tensor:
    """``out[..., i, :] = sum_k vals[..., i, k] * h[..., cols[..., i, k], :]``
    on the card, for one graph (2-D operands) or a stack of P partitions
    (``cols``/``vals`` ``[P, n_rows, K]``, ``h`` ``[P, n_cols, d]``, one
    launch).  Padding slots carry ``vals == 0``.  Does not synchronise."""
    batched = h.dim() == 3
    if not batched:
        cols, vals, h = cols[None], vals[None], h[None]
    _check(cols, vals, h)
    n_parts, n_rows, k = cols.shape
    n_cols, d = h.shape[1], h.shape[2]
    out = torch.empty((n_parts, n_rows, d), dtype=torch.float32,
                      device=h.device)
    if out.numel():
        with torch.cuda.device(h.device):
            stream = torch.cuda.current_stream(h.device).cuda_stream
            err = _entry()(cols.data_ptr(), vals.data_ptr(), h.data_ptr(),
                           out.data_ptr(), n_parts, n_rows, k, n_cols, d,
                           n_rows * k, n_cols * d, n_rows * d, stream)
        ell_spmm.launches += 1
        if err:
            raise RuntimeError(f"ell_spmm kernel launch failed with CUDA "
                               f"error {err}")
    return out if batched else out[0]


ell_spmm.launches = 0
