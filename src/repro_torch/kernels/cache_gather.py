"""Row gather on the card: the wrapper of ``csrc/gather_rows.cu``.

The kernel replaces the JAX package's Pallas TPU kernel
``gather_rows_pallas`` (``src/repro/kernels/cache_gather.py``); its source
says what bounds it on the H100 and what the design does about that.  The
CPU path and the dispatch by device live in :mod:`.ops`, the plain version
in :mod:`.ref`.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = ["gather_rows"]

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


_FN = None


def _entry():
    """The kernel's C entry point, built and loaded at first use."""
    global _FN
    if _FN is None:
        fn = build.load("gather_rows").gather_rows
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i] = src[idx[i]]`` on the card, bit-exact, for ``src``
    ``[n_src, d]`` of 2-, 4- or 8-byte elements (f32, bf16, ...) and
    ``idx`` int32 ``[n_out]``.  An empty ``idx`` launches nothing.  Does
    not synchronise."""
    for name, t in (("src", src), ("idx", idx)):
        if t.device.type != "cuda":
            raise ValueError(f"gather_rows kernel: {name} is on {t.device}, "
                             "not on a CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"gather_rows kernel: {name} must be "
                             "contiguous")
    if idx.device != src.device:
        raise ValueError(f"gather_rows kernel: idx is on {idx.device} but "
                         f"src is on {src.device}")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError(f"gather_rows kernel: idx must be 1-D int32, got "
                        f"{idx.dtype} of shape {tuple(idx.shape)}")
    if src.dim() != 2 or src.element_size() not in (2, 4, 8):
        raise TypeError(f"gather_rows kernel: src must be 2-D with 2-, 4- "
                        f"or 8-byte elements, got {src.dtype} of shape "
                        f"{tuple(src.shape)}")
    n_src, d = src.shape
    n_out = idx.shape[0]
    out = torch.empty((n_out, d), dtype=src.dtype, device=src.device)
    if out.numel():
        with torch.cuda.device(src.device):
            stream = torch.cuda.current_stream(src.device).cuda_stream
            err = _entry()(src.data_ptr(), idx.data_ptr(), out.data_ptr(),
                           n_out, n_src, d, src.element_size(), stream)
        gather_rows.launches += 1
        if err:
            raise RuntimeError(f"gather_rows kernel launch failed with CUDA "
                               f"error {err}")
    return out


gather_rows.launches = 0
