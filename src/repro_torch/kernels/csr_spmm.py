"""Gather-side CSR SpMM on the card: the wrapper of ``csrc/csr_spmm.cu``.

- :class:`CsrPack` — a CSR matrix whose rows and columns are the flattened
  partitions of a stacked layout, with its row list in two classes (short
  rows, and the segments of long rows), as :func:`~.ops.csr_pack` builds it
  once on the host;
- :func:`csr_spmm` — ``A x`` into a new tensor (write mode; the row list
  must hold every row): ``d_h = A^T g``, the backward of the ELL and hybrid
  products over their transposed pack (the row gather's backward is the
  same mode, counted apart: :func:`~.cache_gather.gather_rows_bwd`);
- :func:`csr_spmm_accumulate` — ``out += A x`` in place over the listed
  rows (accumulate mode): the hybrid product's tail forward, after the ELL
  kernel.

``x`` is f32, or bf16 with f32 sums; ``out`` has ``x``'s type.  The plain
version is :func:`~.ref.csr_spmm_ref`; the dispatch by tensor device and
the autograd Functions live in :mod:`.ops`.  Each wrapper checks its
operands, launches on the current stream of the operands' device without
synchronising, raises if the launch fails, and adds one to its
``launches`` counter per call that launches (the C entry point launches a
second, small kernel for the long rows' sums when the pack has long rows).
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from .ell_spmm import _check, _entry, _launch, ell_launch_config

__all__ = ["CsrPack", "csr_spmm", "csr_spmm_accumulate", "ID_LIMIT"]

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# (rowptr, col, w, short_rows, n_short, seg, n_seg, long_rows, long_seg_ptr,
#  n_long, x, out, partial, d, accumulate, vec, stripe_vectors, device,
#  stream)
_ARGTYPES = ([_PTR] * 4 + [_INT, _PTR, _INT] + [_PTR] * 2 + [_INT]
             + [_PTR] * 3 + [_INT] * 5 + [_PTR])
_FLOAT_TYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_INT_FIELDS = ("rowptr", "col", "short_rows", "seg", "long_rows",
               "long_seg_ptr")
# The kernel's ids and entry offsets are int32: a chunk of 32 entries per
# warp, 8 warps per segment, may run 256 entries past the last one.
ID_LIMIT = 2 ** 31 - 1 - 256


@dataclasses.dataclass(frozen=True)
class CsrPack:
    """A CSR matrix ``[n_rows, n_cols]`` and the row list the kernel walks.

    Rows with more than ``long_row`` entries are long: they are cut into
    segments of at most ``long_row`` entries (``seg``), one block each; the
    others are short rows, one warp each, listed longest first.  With
    ``every_row`` the list holds every row, empty ones included (write
    mode); otherwise only rows with entries.  ``perm``, where the builder
    was given ids, is each entry's id (an edge list's edge index), so that
    values given at call time are put in the pack's order with one gather.
    """
    rowptr: torch.Tensor        # int32 [n_rows + 1]
    col: torch.Tensor           # int32 [nnz], in [0, n_cols)
    w: torch.Tensor             # float32 [nnz]
    short_rows: torch.Tensor    # int32 [n_short], longest first
    seg: torch.Tensor           # int32 [n_seg, 2], entry range [lo, hi)
    long_rows: torch.Tensor     # int32 [n_long]
    long_seg_ptr: torch.Tensor  # int32 [n_long + 1], into seg
    n_rows: int
    n_cols: int
    long_row: int
    every_row: bool
    perm: torch.Tensor | None = None   # int32 [nnz], each entry's id

    @property
    def nnz(self) -> int:
        return int(self.col.shape[0])

    def to(self, device) -> "CsrPack":
        fields = _INT_FIELDS + ("w",) + (() if self.perm is None
                                         else ("perm",))
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device) for f in fields})


def _run(kernel: str, pack: CsrPack, x: torch.Tensor, out: torch.Tensor,
         accumulate: bool) -> bool:
    """Check and launch; returns whether a kernel was launched."""
    named = {f: getattr(pack, f) for f in _INT_FIELDS + ("w",)}
    _check(kernel, {"x": x, "out": out, **named}, x.device)
    bad = [f for f in _INT_FIELDS if named[f].dtype != torch.int32]
    if bad or pack.w.dtype != torch.float32:
        raise TypeError(f"{kernel} kernel: the pack's {bad or ['w']} must "
                        "be int32 (w float32)")
    if x.dtype not in _FLOAT_TYPES or out.dtype != x.dtype:
        raise TypeError(f"{kernel} kernel: x must be float32 or bfloat16 "
                        f"and out of its type, got {x.dtype} and "
                        f"{out.dtype}")
    if max(pack.n_rows + 1, pack.n_cols, pack.nnz) > ID_LIMIT:
        raise ValueError(f"{kernel} kernel: ids are int32: {pack.n_rows} "
                         f"rows, {pack.n_cols} columns and {pack.nnz} "
                         f"entries must stay under {ID_LIMIT}")
    if (x.dim() != 2 or x.shape[0] != pack.n_cols
            or out.shape != (pack.n_rows, x.shape[1])):
        raise ValueError(f"{kernel} kernel: x [{pack.n_cols}, d] and out "
                         f"[{pack.n_rows}, d] expected, got "
                         f"{tuple(x.shape)} and {tuple(out.shape)}")
    d = x.shape[1]
    n_seg, n_short = pack.seg.shape[0], pack.short_rows.shape[0]
    if not d or not (n_seg or n_short):
        return False
    partial = (torch.empty((n_seg, d), dtype=torch.float32, device=x.device)
               if n_seg else None)
    vec, stripe = ell_launch_config(d, x.element_size(),
                                    x.data_ptr() | out.data_ptr())
    fn = _entry("csr_spmm", f"csr_spmm_{_FLOAT_TYPES[x.dtype]}", _ARGTYPES)
    _launch(fn, x.get_device(), pack.rowptr.data_ptr(), pack.col.data_ptr(),
            pack.w.data_ptr(), pack.short_rows.data_ptr(), n_short,
            pack.seg.data_ptr(), n_seg, pack.long_rows.data_ptr(),
            pack.long_seg_ptr.data_ptr(), pack.long_rows.shape[0],
            x.data_ptr(), out.data_ptr(),
            None if partial is None else partial.data_ptr(), d,
            int(accumulate), vec, stripe)
    return True


def write_mode(kernel: str, pack: CsrPack,
               x: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """``(A x, launched)``: write mode under the name ``kernel``, for the
    wrappers that count their own launches (:func:`csr_spmm` here, the
    row gather's backward in :mod:`.cache_gather`)."""
    if not pack.every_row:
        raise ValueError(f"{kernel} kernel: write mode needs a pack whose "
                         "row list holds every row (every_row=True)")
    out = torch.empty((pack.n_rows, x.shape[-1]), dtype=x.dtype,
                      device=x.device)
    return out, _run(kernel, pack, x, out, False)


def csr_spmm(pack: CsrPack, x: torch.Tensor) -> torch.Tensor:
    """``A x``, ``[pack.n_rows, d]`` in ``x``'s type (f32 sums), for ``x``
    ``[pack.n_cols, d]``.  The pack's row list must hold every row: each
    row of the result is written once, so it needs no zero fill, and the
    same inputs give the same bits."""
    out, launched = write_mode("csr_spmm", pack, x)
    csr_spmm.launches += int(launched)
    return out


def csr_spmm_accumulate(pack: CsrPack, x: torch.Tensor,
                        out: torch.Tensor) -> torch.Tensor:
    """``out += A x`` in place over the rows the pack lists (f32 sums, one
    rounding to ``out``'s type per row); returns ``out``."""
    csr_spmm_accumulate.launches += int(
        _run("csr_spmm_accumulate", pack, x, out, True))
    return out


for _fn in (csr_spmm, csr_spmm_accumulate):
    _fn.launches = 0
