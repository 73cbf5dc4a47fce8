"""Row gather on the card: the wrapper of ``csrc/gather_rows.cu``, and
its backward.

- :func:`gather_rows` — the forward kernel; it replaces the JAX package's
  Pallas TPU kernel ``gather_rows_pallas``
  (``src/repro/kernels/cache_gather.py``), and its source says what bounds
  it on the H100 and what the design does about that;
- :func:`gather_rows_bwd` — ``d_src = M g`` for the transposed index map
  ``M`` (:func:`~.ops.gather_pack`): ``csrc/csr_spmm.cu`` in write mode, a
  row sent to k consumers summing their k rows in a fixed order, with no
  atomics and no zero fill.  The JAX package leaves this VJP to XLA (the
  transpose of ``jnp.take``, a scatter-add).

The differentiable gather (:class:`~.ops.GatherRowsFn`), the CPU path and
the dispatch by device live in :mod:`.ops`, the plain versions in
:mod:`.ref`.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .csr_spmm import CsrPack, write_mode

__all__ = ["gather_rows", "gather_rows_bwd"]

# (src, idx, out, n_out, n_src, row_bytes, device, stream)
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
_ELEM_BYTES = (2, 4, 8)

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


def _takes(src: torch.Tensor, idx: torch.Tensor) -> bool:
    """Whether the kernel takes ``src`` and ``idx``, in one expression."""
    # idx is on src's CUDA device when their device indices match (a CPU
    # tensor's is -1)
    return (src.is_cuda and src.get_device() == idx.get_device()
            and src.dim() == 2 and idx.dim() == 1
            and idx.dtype == torch.int32
            and src.element_size() in _ELEM_BYTES and src.is_contiguous()
            and idx.is_contiguous())


def _refuse(src: torch.Tensor, idx: torch.Tensor) -> None:
    """Raise the error that says why the kernel does not take ``src`` and
    ``idx``."""
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
    raise TypeError(f"gather_rows kernel: src must be 2-D with 2-, 4- or "
                    f"8-byte elements, got {src.dtype} of shape "
                    f"{tuple(src.shape)}")


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i] = src[idx[i]]`` on the card, bit-exact, for ``src``
    ``[n_src, d]`` of 2-, 4- or 8-byte elements (f32, bf16, ...) and
    ``idx`` int32 ``[n_out]``; an index outside ``[0, n_src)`` gives a row
    of zero bits.  An empty ``idx`` launches nothing.  Launches on the
    current stream of ``src``'s device; does not synchronise.

    The serving engine calls it once per micro-batch for a few rows, so the
    host path is what a call costs: one combined test of the operands (the
    itemised checks run only to word the error), the output's allocation
    and one ctypes call with the raw stream."""
    if not _takes(src, idx):
        _refuse(src, idx)
    n_out = idx.shape[0]
    n_src, d = src.shape
    out = src.new_empty((n_out, d))
    if n_out and d:
        dev = src.get_device()
        err = _entry()(src.data_ptr(), idx.data_ptr(), out.data_ptr(), n_out,
                       n_src, d * src.element_size(), dev,
                       torch._C._cuda_getCurrentRawStream(dev))
        gather_rows.launches += 1
        if err:
            raise RuntimeError(f"gather_rows kernel launch failed with CUDA "
                               f"error {err}")
    return out


gather_rows.launches = 0


def gather_rows_bwd(pack: CsrPack, g: torch.Tensor) -> torch.Tensor:
    """``d_src [pack.n_rows, d]`` of ``out = src[idx]`` for the output's
    cotangent ``g [n_out, d]`` (f32, or bf16 with f32 sums), over ``pack``
    = :func:`~.ops.gather_pack` of ``idx``: row ``r`` is the sum of the
    ``g`` rows whose id is ``r``, in the order of their positions, and 0
    for a row no id names.  Two launches give the same bits."""
    d_src, launched = write_mode("gather_rows_bwd", pack, g.contiguous())
    gather_rows_bwd.launches += int(launched)
    return d_src


gather_rows_bwd.launches = 0
