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

``x`` is f32, or bf16 with f32 sums; ``out`` has ``x``'s type.  A pack
whose ``w`` is ``[H, nnz]`` (GAT's heads, :func:`~.ops.edge_spmm`) takes
``x [n_cols, H, dh]`` and gives ``[n_rows, H, dh]``: H products in one
launch, head ``z`` with values ``w[z]`` over the columns of head ``z``.
The plain version is :func:`~.ref.csr_spmm_ref`; the dispatch by tensor
device and the autograd Functions live in :mod:`.ops`.  Each wrapper
checks its operands, launches on the current stream of the operands'
device without synchronising, raises if the launch fails, and adds one to
its ``launches`` counter per call that launches (the C entry point
launches a second, small kernel for the long rows' sums when the pack has
long rows).  :func:`csr_launch_config` picks the kernel's vector width,
feature stripe and load mode on the host.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from .ell_spmm import _check, _entry, _launch, ell_launch_config

__all__ = ["CsrPack", "csr_spmm", "csr_spmm_accumulate", "csr_launch_config",
           "mean_row", "ID_LIMIT"]

_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (rowptr, col, w, w_head_stride, short_rows, n_short, seg, n_seg,
#  long_rows, long_seg_ptr, n_long, x, out, partial, d, ld, heads,
#  accumulate, vec, stripe_vectors, mode, device, stream)
_ARGTYPES = ([_PTR] * 3 + [_I64, _PTR, _INT, _PTR, _INT] + [_PTR] * 2
             + [_INT] + [_PTR] * 3 + [_INT, _I64] + [_INT] * 6 + [_PTR])
_FLOAT_TYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_INT_FIELDS = ("rowptr", "col", "short_rows", "seg", "long_rows",
               "long_seg_ptr", "runs", "short_span", "seg_long")
# The kernel's ids and entry offsets are int32: a chunk of 32 entries per
# warp, 8 warps per segment, may run 256 entries past the last one.
ID_LIMIT = 2 ** 31 - 1 - 256

# How a warp keeps its x loads in flight (csrc/csr_spmm.cu's Mode): two or
# four entry steps in registers, or a ring of stages in shared memory
# filled by cp.async; the last two with 16-byte words only.
MODES = {"regs2": 0, "regs4": 1, "ring": 2}


# Mean entries a listed row above which a 1 KB row goes in two 512-byte
# stripes of four register steps, not one stripe through the ring: the
# ring won by 2-26% at 0.6-14 entries a row (the train cell's edge, d_h
# and gather packs) and lost by 9% at 32 (the 1.5D chunk), at any size of
# x (PERF.md, chip_smoke.py --kernels-only: x folded into 8k-48k rows).
RING_MEAN_ROW = 20


def csr_launch_config(d: int, elem_bytes: int, addr_bits: int,
                      mean_row: float = 0.0, stripe_bytes: int | None = None,
                      mode: str | None = None) -> tuple[int, int, int]:
    """``(vec, stripe_vectors, mode)`` of the CSR kernel for x rows of
    ``d`` elements of ``elem_bytes`` bytes a head, over a pack of
    ``mean_row`` entries a listed row: the vector and stripe as
    :func:`~.ell_spmm.ell_launch_config` picks them (``addr_bits`` the OR
    of the base addresses and the row stride's bytes), and the load mode.
    A row of at most 1 KB is one stripe, walked with the cp.async ring
    where that takes two 16-byte words a lane (rows of 513-1,024 bytes: d
    = 256 in f32) and four register steps otherwise, but in 512-byte
    stripes where rows hold more than :data:`RING_MEAN_ROW` entries on
    average; a wider row goes in 256-byte stripes with four register
    steps: the fastest on the H100 at the train cell's routes (PERF.md,
    ``chip_smoke.py --kernels-only``, whose variants name their own
    ``stripe_bytes`` and ``mode``).  Words narrower than 16 bytes take
    ``regs2``."""
    row = d * elem_bytes
    if not stripe_bytes:
        stripe_bytes = 256 if row > 1024 else (
            1024 if mean_row <= RING_MEAN_ROW else 512)
    vec, stripe = ell_launch_config(d, elem_bytes, addr_bits, stripe_bytes)
    if vec * elem_bytes != 16:
        return vec, stripe, MODES["regs2"]
    return vec, stripe, MODES[mode or ("ring" if stripe == 64 else "regs4")]


def mean_row(pack: "CsrPack") -> float:
    """Entries a row of the pack's row list, on average."""
    return pack.nnz / max(1, pack.short_rows.shape[0]
                          + pack.long_rows.shape[0])


@dataclasses.dataclass(frozen=True)
class CsrPack:
    """A CSR matrix ``[n_rows, n_cols]`` and the row list the kernel walks.

    Rows with more than ``long_row`` entries are long: they are cut into
    segments of at most ``long_row`` entries (``seg``), one block each; the
    others are short rows, one warp each, listed longest first.  With
    ``every_row`` the list holds every row, empty ones included (write
    mode); otherwise only rows with entries.  GAT's edge softmax
    (``csrc/edge_softmax.cu``) walks the short rows in groups of lanes:
    ``runs`` cuts the list into runs of rows that take the same number of
    lanes (the least power of two at or above a row's entries, at most
    32; none for an empty row), each run ``(first row in short_rows, first
    warp, log2 of its lanes)`` and a last line ``(n_short, run_warps,
    0)``; ``short_span`` is each listed short row's entry range
    ``[rowptr[r], rowptr[r + 1])``, read with the row itself (one
    dependent load fewer than through ``rowptr``); ``seg_long`` is each
    segment's long row (its index into ``long_rows``).  ``perm``, where
    the pack was built with ids, is each entry's id (an edge list's edge
    index), so that values given at call time are put in the pack's order
    with one gather.
    """
    rowptr: torch.Tensor        # int32 [n_rows + 1]
    col: torch.Tensor           # int32 [nnz], in [0, n_cols)
    w: torch.Tensor             # float32 [nnz] ([H, nnz]: one per head)
    short_rows: torch.Tensor    # int32 [n_short], longest first
    seg: torch.Tensor           # int32 [n_seg, 2], entry range [lo, hi)
    long_rows: torch.Tensor     # int32 [n_long]
    long_seg_ptr: torch.Tensor  # int32 [n_long + 1], into seg
    runs: torch.Tensor          # int32 [n_runs + 1, 3], the short rows' runs
    short_span: torch.Tensor    # int32 [n_short, 2], their entry ranges
    seg_long: torch.Tensor      # int32 [n_seg], each segment's long row
    n_rows: int
    n_cols: int
    long_row: int
    every_row: bool
    run_warps: int              # warps over the runs (their last line)
    perm: torch.Tensor | None = None   # int32 [nnz], each entry's id

    @property
    def nnz(self) -> int:
        return int(self.col.shape[0])

    def to(self, device) -> "CsrPack":
        fields = _INT_FIELDS + ("w",) + (() if self.perm is None
                                         else ("perm",))
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device) for f in fields})


def _heads(pack: CsrPack) -> int:
    """The products a launch computes: ``w [H, nnz]`` gives H."""
    return pack.w.shape[0] if pack.w.dim() == 2 else 1


def _run(kernel: str, pack: CsrPack, x: torch.Tensor, out: torch.Tensor,
         accumulate: bool, config: tuple = ()) -> bool:
    """Check and launch; returns whether a kernel was launched.
    ``config``, ``(stripe_bytes, mode)``, overrides
    :func:`csr_launch_config`'s choice (a sweep of the variants)."""
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
    heads = _heads(pack)
    lead = (heads,) if pack.w.dim() == 2 else ()
    if (x.dim() != 2 + len(lead) or x.shape[0] != pack.n_cols
            or tuple(x.shape[1:-1]) != lead
            or out.shape != (pack.n_rows,) + tuple(x.shape[1:])
            or pack.w.shape != lead + (pack.nnz,)):
        want = "[{}, H, dh]" if lead else "[{}, d]"
        raise ValueError(f"{kernel} kernel: x {want.format(pack.n_cols)} "
                         f"and out {want.format(pack.n_rows)} for w "
                         f"{tuple(pack.w.shape)} expected, got "
                         f"{tuple(x.shape)} and {tuple(out.shape)}")
    d = x.shape[-1]
    n_seg, n_short = pack.seg.shape[0], pack.short_rows.shape[0]
    if not d or not (n_seg or n_short):
        return False
    partial = (torch.empty((heads, n_seg, d), dtype=torch.float32,
                           device=x.device) if n_seg else None)
    ld = heads * d
    vec, stripe, mode = csr_launch_config(
        d, x.element_size(),
        x.data_ptr() | out.data_ptr() | ld * x.element_size(),
        mean_row(pack), *config)
    fn = _entry("csr_spmm", f"csr_spmm_{_FLOAT_TYPES[x.dtype]}", _ARGTYPES)
    _launch(fn, x.get_device(), pack.rowptr.data_ptr(), pack.col.data_ptr(),
            pack.w.data_ptr(), pack.nnz, pack.short_rows.data_ptr(), n_short,
            pack.seg.data_ptr(), n_seg, pack.long_rows.data_ptr(),
            pack.long_seg_ptr.data_ptr(), pack.long_rows.shape[0],
            x.data_ptr(), out.data_ptr(),
            None if partial is None else partial.data_ptr(), d, ld, heads,
            int(accumulate), vec, stripe, mode)
    return True


def write_mode(kernel: str, pack: CsrPack, x: torch.Tensor,
               config: tuple = ()) -> tuple[torch.Tensor, bool]:
    """``(A x, launched)``: write mode under the name ``kernel``, for the
    wrappers that count their own launches (:func:`csr_spmm` here, the
    row gather's backward in :mod:`.cache_gather`); ``config`` as
    :func:`_run` takes it."""
    if not pack.every_row:
        raise ValueError(f"{kernel} kernel: write mode needs a pack whose "
                         "row list holds every row (every_row=True)")
    out = torch.empty((pack.n_rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out, _run(kernel, pack, x, out, False, config)


def csr_spmm(pack: CsrPack, x: torch.Tensor) -> torch.Tensor:
    """``A x``, ``[pack.n_rows, d]`` in ``x``'s type (f32 sums), for ``x``
    ``[pack.n_cols, d]`` (``[pack.n_cols, H, dh]`` into ``[pack.n_rows, H,
    dh]`` when the pack's ``w`` is ``[H, nnz]``).  The pack's row list
    must hold every row: each row of the result is written once, so it
    needs no zero fill, and the same inputs give the same bits."""
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
