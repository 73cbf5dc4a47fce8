"""The port's aggregation and gather ops: numpy ELL and CSR packing, the
differentiable ELL and hybrid products, and the dispatch by tensor device
between the CUDA kernels and their plain versions.

A CPU tensor takes the plain version in :mod:`.ref`; a CUDA tensor
launches the hand-written kernel (:mod:`.ell_spmm`, :mod:`.csr_spmm`,
:mod:`.cache_gather`), whose wrapper raises on anything it does not take.
There is no fallback from the card to the plain version.

The ELL and hybrid products are one autograd Function each
(:class:`EllSpmmFn`, :class:`HybridSpmmFn`) on both devices.  Their
``d_h = A^T g`` is the CSR kernel over the transposed pack of the whole
adjacency (:func:`transpose_csr`: the ELL slots and, for ``hybrid``, the
COO tail), and the hybrid tail's forward is the same kernel over the
tail's own CSR (:func:`tail_csr`), added into the ELL kernel's output.
Both packs are built once where the stacked layout goes to the device
(``dist.capgnn_sim.make_adj_builder``); a caller that passes none gets
them built for its call (:func:`pack_for_call`).

The ``edges`` backend's aggregation (the JAX package's ``segment_sum``
backend) is :func:`coo_spmm` on CPU tensors and, on CUDA tensors,
:class:`EdgeSpmmFn` over the edge list's CSR packs (:func:`edge_packs`,
built on the device once where the edge list goes there, and per call
for the serving engine's subgraphs): the CSR kernel in write mode over
``A`` forward and over ``A^T`` for ``d_h``, and
``csrc/edge_dvals.cu`` for the per-edge values' cotangent.  GAT's layer
is :class:`EdgeAttentionFn` over the same packs: its edge softmax
(``csrc/edge_softmax.cu``) writes the attention in ``A``'s order, the
values of the CSR kernel's forward, and its backward walks ``A`` and
``A^T`` (through the packs' entry map) for the scores' cotangents and the
attention in ``A^T``'s order for ``d_h``.  An edge list on the card
without its packs raises.

The row gather (:func:`gather_rows`, and :func:`pack_rows` over any index
shape) is differentiable in ``src`` through :class:`GatherRowsFn` whenever
autograd records: its backward is the CSR kernel in write mode over the
transposed index map (:func:`gather_pack`), so no path meets PyTorch's
sort-based indexing backward.  Outside autograd it is the raw kernel call.

Each of the Functions keeps the name of the device scope its forward
ran under (:func:`~repro_torch.obs.annotations.current_scope`) and runs
its backward inside ``transpose(<that name>)``: the backward's kernels,
launched by autograd's thread, land in a profiler range too.

Out-of-range ids have one contract on both devices: an id outside
``[0, n)`` reads a zero row, in the gather and in the ELL slots (their
columns), as the CUDA kernels do and as :mod:`.ref` does with
``torch.where``; a CSR pack refuses such entries (:func:`csr_pack`), and
:func:`gather_pack` leaves them out.  The JAX package's ``jnp.take``
wraps a negative id and gives a row of NaN past the end; no pack built by
either package carries such an id.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..obs.annotations import current_scope, transpose_scope
from . import cache_gather as _gather_mod
from . import edge_spmm as _edge
from . import ell_spmm as _ell
from . import ref as _ref
from .csr_spmm import ID_LIMIT, CsrPack, csr_spmm, csr_spmm_accumulate

__all__ = ["ell_pack", "ell_pack_hybrid", "ell_row_end", "LONG_ROW",
           "csr_pack", "csr_pack_torch", "transpose_csr", "tail_csr",
           "pack_for_call", "gather_pack", "EdgePacks", "edge_packs",
           "segment_ids", "segment_sum", "coo_spmm", "value_heads",
           "EllSpmmFn", "HybridSpmmFn", "EdgeSpmmFn", "EdgeAttentionFn",
           "GatherRowsFn", "ell_spmm", "hybrid_spmm", "edge_spmm",
           "edge_attention", "gather_rows", "pack_rows", "cache_combine",
           "ell_stats"]

# A CSR row with more entries than this is long: the kernel cuts it into
# segments of at most this many entries, one block each (PERF.md: the
# `--sweep` of chip_smoke.py over 64-1024).
LONG_ROW = 256
# GAT's edge softmax gives a short row of n entries the least power of two
# >= n lanes, at most a warp (CsrPack.runs); a run of empty rows has this
# log2 of lanes and no warps
_EMPTY_RUN = 6


def ell_pack(src: np.ndarray, dst: np.ndarray, w: np.ndarray, n_rows: int,
             max_deg: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Pack COO (src->dst) edges into ELL rows indexed by dst.

    Returns (cols, vals) of shape [n_rows, max_deg]; padding entries have
    col id 0 and val 0 (the plain-version/kernel contract).
    """
    deg = np.bincount(dst, minlength=n_rows)
    md = int(deg.max()) if max_deg is None and deg.size else (max_deg or 1)
    md = max(1, md)
    cols = np.zeros((n_rows, md), dtype=np.int32)
    vals = np.zeros((n_rows, md), dtype=np.float32)
    order = np.argsort(dst, kind="stable")
    src_s, dst_s, w_s = src[order], dst[order], w[order]
    # vectorised slot assignment: position within each dst group
    starts = np.searchsorted(dst_s, np.arange(n_rows))
    pos_in_group = np.arange(dst_s.shape[0]) - starts[dst_s]
    keep = pos_in_group < md
    cols[dst_s[keep], pos_in_group[keep]] = src_s[keep]
    vals[dst_s[keep], pos_in_group[keep]] = w_s[keep]
    return cols, vals


def ell_pack_hybrid(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                    n_rows: int, quantile: float = 0.95
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                               np.ndarray, np.ndarray]:
    """Hybrid ELL+COO pack: rows are packed to the ``quantile`` degree; the
    overflow edges of heavy rows go to a COO tail (power-law degree skew
    makes plain ELL ~98% padding).

    Returns (cols, vals, tail_src, tail_dst, tail_w).
    """
    deg = np.bincount(dst, minlength=n_rows)
    md = max(1, int(np.quantile(deg[deg > 0], quantile))) if deg.any() else 1
    order = np.argsort(dst, kind="stable")
    src_s, dst_s, w_s = src[order], dst[order], w[order]
    starts = np.searchsorted(dst_s, np.arange(n_rows))
    pos_in_group = np.arange(dst_s.shape[0]) - starts[dst_s]
    keep = pos_in_group < md
    cols = np.zeros((n_rows, md), dtype=np.int32)
    vals = np.zeros((n_rows, md), dtype=np.float32)
    cols[dst_s[keep], pos_in_group[keep]] = src_s[keep]
    vals[dst_s[keep], pos_in_group[keep]] = w_s[keep]
    return (cols, vals, src_s[~keep].astype(np.int32),
            dst_s[~keep].astype(np.int32), w_s[~keep].astype(np.float32))


def ell_stats(cols: np.ndarray, vals: np.ndarray) -> dict:
    """Padding-waste report of an ELL pack (how ELL-friendly the
    partition is): live slots (``vals != 0``), all slots, the share of
    padding and the pack's width."""
    nnz = int((np.asarray(vals) != 0).sum())
    total = int(np.asarray(vals).size)
    return {"nnz": nnz, "slots": total,
            "pad_waste": 1.0 - nnz / max(1, total),
            "max_deg": int(np.asarray(vals).shape[1])}


def ell_row_end(vals: np.ndarray) -> np.ndarray:
    """One past each ELL row's last live slot (``vals != 0``), 0 for a row
    without one: int32 ``vals.shape[:-1]``.  The forward kernel reads no
    slot past it; any pack, whatever the order of its slots."""
    live = np.asarray(vals) != 0
    last = live.shape[-1] - np.argmax(live[..., ::-1], axis=-1)
    return np.where(live.any(-1), last, 0).astype(np.int32)


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _check_csr(name: str, n_rows: int, n_cols: int, nnz: int,
               long_row: int) -> None:
    if max(n_rows + 1, n_cols, nnz) > ID_LIMIT:
        raise ValueError(f"{name}: ids are int32: {n_rows} rows, {n_cols} "
                         f"columns and {nnz} entries must stay under "
                         f"{ID_LIMIT}")
    if long_row < 1:
        raise ValueError(f"{name}: long_row must be >= 1, got {long_row}")


def _short_order_key(first_col, counts, short, col_block: int | None,
                     long_row: int, n_blocks: int):
    """The sort key of the short rows ``short``: their block (that of
    their first column; empty rows after every block), then longest
    first.  Works on numpy arrays and torch tensors alike."""
    longest_first = long_row - counts[short]
    if col_block is None:
        return longest_first
    block = first_col[short] // col_block
    block = block * (counts[short] > 0) + n_blocks * (counts[short] == 0)
    return block * (long_row + 1) + longest_first


def _lanes_log2(n):
    """log2 of the lanes a short row of ``n`` entries takes (numpy or
    torch integers): the least power of two >= n, at most 32;
    :data:`_EMPTY_RUN` for an empty row."""
    lg = 5 - sum((n <= 2 ** i) * 1 for i in range(5))
    return lg * (n > 0) + _EMPTY_RUN * (n == 0)


def _runs_np(lg: np.ndarray) -> tuple[np.ndarray, int]:
    """``(runs, run_warps)`` of a short list whose rows take ``2 ** lg``
    lanes (:func:`_lanes_log2`): one line a run of equal ``lg``, ``(first
    row, first warp, lg)``, and the last line ``(rows, warps, 0)``."""
    starts = np.flatnonzero(np.diff(lg, prepend=-1))
    lgs = lg[starts]
    live = lgs < _EMPTY_RUN
    per = 2 ** (5 - np.where(live, lgs, 5))          # rows a warp
    warps = np.where(live, -(-np.diff(np.append(starts, lg.size)) // per),
                     0)
    first = np.concatenate([[0], np.cumsum(warps)])
    runs = np.stack([np.append(starts, lg.size), first, np.append(lgs, 0)],
                    axis=1)
    return runs, int(first[-1])


def _runs_torch(lg: torch.Tensor) -> tuple[torch.Tensor, int]:
    """:func:`_runs_np` with torch ops, on the device of ``lg``."""
    new = torch.ones_like(lg, dtype=torch.bool)
    new[1:] = lg[1:] != lg[:-1]
    starts = torch.nonzero(new).squeeze(1)
    lgs = lg[starts]
    live = lgs < _EMPTY_RUN
    per = 2 ** (5 - torch.where(live, lgs, 5))
    end = starts.new_full((1,), lg.numel())
    warps = torch.where(live, -(-torch.diff(torch.cat([starts, end]))
                                // per), 0)
    first = torch.cat([warps.new_zeros(1), torch.cumsum(warps, 0)])
    runs = torch.stack([torch.cat([starts, end]), first,
                        torch.cat([lgs, lgs.new_zeros(1)])], dim=1)
    return runs, int(first[-1])


def _check_block(name: str, n_cols: int, col_block: int | None) -> int:
    """The number of column blocks (1 without ``col_block``)."""
    if col_block is None:
        return 1
    if col_block < 1:
        raise ValueError(f"{name}: col_block must be >= 1, got {col_block}")
    return -(-n_cols // col_block)


def csr_pack(rows: np.ndarray, cols: np.ndarray, w: np.ndarray,
             n_rows: int, n_cols: int, every_row: bool,
             long_row: int = LONG_ROW, device="cpu",
             ids: np.ndarray | None = None,
             col_block: int | None = None) -> CsrPack:
    """The entries ``(rows[e], cols[e], w[e])`` of an ``[n_rows, n_cols]``
    matrix as a :class:`~.csr_spmm.CsrPack` on ``device``: sorted by row,
    then column; rows of more than ``long_row`` entries cut into equal
    segments of at most ``long_row``; the other rows listed longest first,
    empty ones too when ``every_row``; with ``ids``, each entry's id in the
    pack's order as ``perm``.

    ``col_block`` (the columns of one partition of a stacked layout) lists
    the short rows block by block, a row's block being that of its first
    column, and longest first within a block (empty rows last): the warps
    in flight then read the x rows of one partition.  The transposed
    packs take it (:func:`transpose_csr`, :func:`edge_packs`' ``bwd``),
    whose x is the gradient, a partition of which the L2 holds (24k rows,
    25 MB at the train cell's d = 256); a forward pack's partition of x
    (49k rows, 50 MB) does not fit, and there the order measured slower
    than longest first over the whole stack (PERF.md §6).  Ids are
    int32: raises past
    :data:`~.csr_spmm.ID_LIMIT`.  :func:`csr_pack_torch` builds the same
    fields with torch ops."""
    rows = np.asarray(rows, np.int64).ravel()
    cols = np.asarray(cols, np.int64).ravel()
    w = np.asarray(w, np.float32).ravel()
    _check_csr("csr_pack", n_rows, n_cols, rows.size, long_row)
    n_blocks = _check_block("csr_pack", n_cols, col_block)
    if rows.size and (rows.min() < 0 or rows.max() >= n_rows
                      or cols.min() < 0 or cols.max() >= n_cols):
        raise ValueError(f"csr_pack: entries outside [{n_rows}, {n_cols}]")
    order = np.lexsort((cols, rows))
    cols, w = cols[order], w[order]
    counts = np.bincount(rows, minlength=n_rows)
    rowptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(counts, out=rowptr[1:])
    is_long = counts > long_row
    long_rows = np.flatnonzero(is_long)
    n_seg = -(-counts[long_rows] // long_row)
    long_seg_ptr = np.zeros(long_rows.size + 1, np.int64)
    np.cumsum(n_seg, out=long_seg_ptr[1:])
    # segment j of s of a row with n entries from `start`:
    # [start + j * n // s, start + (j + 1) * n // s)
    seg_row = np.repeat(long_rows, n_seg)
    j = np.arange(seg_row.size) - np.repeat(long_seg_ptr[:-1], n_seg)
    s, n, start = np.repeat(n_seg, n_seg), counts[seg_row], rowptr[seg_row]
    seg = np.stack([start + j * n // s, start + (j + 1) * n // s], axis=1)
    short = np.flatnonzero(~is_long & ((counts > 0) | every_row))
    first_col = np.append(cols, 0)[rowptr[:-1]]
    short = short[np.argsort(_short_order_key(
        first_col, counts, short, col_block, long_row, n_blocks),
        kind="stable")]

    runs, run_warps = _runs_np(_lanes_log2(counts[short]))

    def put(a, dtype=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a), device=device
                               ).to(dtype)
    perm = None if ids is None else put(np.asarray(ids).ravel()[order])
    return CsrPack(rowptr=put(rowptr), col=put(cols),
                   w=put(w, torch.float32), short_rows=put(short),
                   seg=put(seg.reshape(-1, 2)), long_rows=put(long_rows),
                   long_seg_ptr=put(long_seg_ptr), runs=put(runs),
                   short_span=put(np.stack([rowptr[short], rowptr[short + 1]],
                                           axis=1)),
                   seg_long=put(np.repeat(np.arange(long_rows.size), n_seg)),
                   n_rows=int(n_rows), n_cols=int(n_cols),
                   long_row=int(long_row), every_row=bool(every_row),
                   run_warps=run_warps, perm=perm)


def csr_pack_torch(rows: torch.Tensor, cols: torch.Tensor, w: torch.Tensor,
                   n_rows: int, n_cols: int, every_row: bool,
                   long_row: int = LONG_ROW,
                   ids: torch.Tensor | None = None,
                   col_block: int | None = None) -> CsrPack:
    """:func:`csr_pack` with torch ops, on the device of ``rows``: the same
    fields, bit for bit (a stable sort by ``row * n_cols + col`` is
    ``np.lexsort``'s order, and one stable sort by the same key orders
    the short rows).  For entries already on the device (the edge lists,
    :func:`edge_packs`): nothing goes through the host but the checks'
    one read and the sizes of the row classes."""
    dev = rows.device
    rows, cols = rows.reshape(-1).long(), cols.reshape(-1).long()
    _check_csr("csr_pack_torch", n_rows, n_cols, rows.numel(), long_row)
    n_blocks = _check_block("csr_pack_torch", n_cols, col_block)
    if rows.numel() and bool((rows.min() < 0) | (rows.max() >= n_rows)
                             | (cols.min() < 0) | (cols.max() >= n_cols)):
        raise ValueError(f"csr_pack_torch: entries outside "
                         f"[{n_rows}, {n_cols}]")
    order = torch.sort(rows * n_cols + cols, stable=True).indices
    cols = cols[order]
    counts = torch.bincount(rows, minlength=n_rows)
    rowptr = torch.zeros(n_rows + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=rowptr[1:])
    is_long = counts > long_row
    long_rows = torch.nonzero(is_long).squeeze(1)
    n_seg = -(-counts[long_rows] // long_row)
    long_seg_ptr = torch.zeros(long_rows.numel() + 1, dtype=torch.int64,
                               device=dev)
    torch.cumsum(n_seg, 0, out=long_seg_ptr[1:])
    seg_row = torch.repeat_interleave(long_rows, n_seg)
    j = torch.arange(seg_row.numel(), device=dev) - torch.repeat_interleave(
        long_seg_ptr[:-1], n_seg)
    s = torch.repeat_interleave(n_seg, n_seg)
    n, start = counts[seg_row], rowptr[seg_row]
    seg = torch.stack([start + j * n // s, start + (j + 1) * n // s], dim=1)
    short = torch.nonzero(~is_long & ((counts > 0) | every_row)).squeeze(1)
    first_col = torch.cat([cols, cols.new_zeros(1)])[rowptr[:-1]]
    short = short[torch.sort(_short_order_key(
        first_col, counts, short, col_block, long_row, n_blocks),
        stable=True).indices]

    runs, run_warps = _runs_torch(_lanes_log2(counts[short]))

    def i32(a):
        return a.to(torch.int32).contiguous()
    return CsrPack(rowptr=i32(rowptr), col=i32(cols),
                   w=w.reshape(-1).float()[order].contiguous(),
                   short_rows=i32(short), seg=i32(seg.reshape(-1, 2)),
                   long_rows=i32(long_rows), long_seg_ptr=i32(long_seg_ptr),
                   runs=i32(runs),
                   short_span=i32(torch.stack([rowptr[short],
                                               rowptr[short + 1]], dim=1)),
                   seg_long=i32(torch.repeat_interleave(
                       torch.arange(long_rows.numel(), device=dev), n_seg)),
                   n_rows=int(n_rows), n_cols=int(n_cols),
                   long_row=int(long_row), every_row=bool(every_row),
                   run_warps=run_warps,
                   perm=None if ids is None else i32(ids.reshape(-1)[order]))


def _stacked_tail(tail_src, tail_dst, tail_w, n_parts: int):
    return (_np(a).reshape(n_parts, -1) for a in (tail_src, tail_dst, tail_w))


def transpose_csr(cols, vals, n_cols: int, tail_src=None, tail_dst=None,
                  tail_w=None, long_row: int = LONG_ROW,
                  device="cpu") -> CsrPack:
    """``A^T`` of an ELL (``[P, n_rows, K]`` or ``[n_rows, K]``) pack, plus
    its COO tail when given, over the flattened partitions: every live ELL
    slot ``(p, i, k)`` (``vals != 0``, column in ``[0, n_cols)``) and every
    tail entry with ``tail_dst < n_rows`` becomes the entry ``(p * n_cols
    + column, p * n_rows + i, w)``.  ``[P * n_cols, P * n_rows]``, every
    row listed, its short rows partition by partition (``col_block``):
    :func:`~.csr_spmm.csr_spmm` of it and ``g`` (``[P * n_rows, d]``) is
    ``d_h``."""
    cols, vals = _np(cols), _np(vals)
    if cols.ndim == 2:
        cols, vals = cols[None], vals[None]
    n_parts, n_rows, _ = cols.shape
    p, i, k = np.nonzero((vals != 0) & (cols >= 0) & (cols < n_cols))
    rows = [p * n_cols + cols[p, i, k]]
    tcols = [p * n_rows + i]
    ws = [vals[p, i, k]]
    if tail_src is not None:
        ts, td, tw = _stacked_tail(tail_src, tail_dst, tail_w, n_parts)
        q, m = np.nonzero(td < n_rows)
        rows.append(q * n_cols + ts[q, m])
        tcols.append(q * n_rows + td[q, m])
        ws.append(tw[q, m])
    return csr_pack(np.concatenate(rows), np.concatenate(tcols),
                    np.concatenate(ws), n_parts * n_cols, n_parts * n_rows,
                    every_row=True, long_row=long_row, device=device,
                    col_block=n_rows)


def tail_csr(tail_src, tail_dst, tail_w, n_rows: int, n_cols: int,
             long_row: int = LONG_ROW, device="cpu") -> CsrPack:
    """The hybrid pack's COO tail (``[P, MT]`` or ``[MT]``; padding carries
    ``tail_dst == n_rows``) as a CSR over the flattened partitions: entry
    ``(p * n_rows + tail_dst, p * n_cols + tail_src, tail_w)``,
    ``[P * n_rows, P * n_cols]``, only rows with entries listed."""
    n_parts = 1 if _np(tail_src).ndim == 1 else _np(tail_src).shape[0]
    ts, td, tw = _stacked_tail(tail_src, tail_dst, tail_w, n_parts)
    q, m = np.nonzero(td < n_rows)
    return csr_pack(q * n_rows + td[q, m], q * n_cols + ts[q, m], tw[q, m],
                    n_parts * n_rows, n_parts * n_cols, every_row=False,
                    long_row=long_row, device=device)


def gather_pack(idx, n_src: int, long_row: int = LONG_ROW,
                device="cpu") -> CsrPack:
    """The transposed index map of ``out = src[idx]`` (``idx`` flattened,
    ``n_out`` ids) as a CSR ``[n_src, n_out]``: entry ``(idx[i], i, 1)`` for
    every id in ``[0, n_src)``, every row listed.  :func:`~.csr_spmm.
    csr_spmm` of it and the output's cotangent is ``d_src``; ids outside
    ``[0, n_src)`` drop out (they read zero rows)."""
    idx = _np(idx).astype(np.int64).ravel()
    valid = (idx >= 0) & (idx < n_src)
    return csr_pack(idx[valid], np.flatnonzero(valid),
                    np.ones(int(valid.sum()), np.float32), n_src, idx.size,
                    every_row=True, long_row=long_row, device=device)


def pack_for_call(build, *args, **kwargs) -> CsrPack:
    """``build(*args, **kwargs)``: a pack made on the host for one call
    whose caller passed none, counted in ``pack_for_call.builds``.  No main
    path takes this route (``chip_smoke.py`` holds the count at 0 there):
    their packs are built once, in ``make_adj_builder`` and, for the tier
    pulls' gathers, ``exchange_arrays``."""
    pack_for_call.builds += 1
    return build(*args, **kwargs)


pack_for_call.builds = 0


@dataclasses.dataclass(frozen=True)
class EdgePacks:
    """An edge list's CSR packs over its flattened partitions: ``fwd`` is
    ``A [P * n_rows, P * n_cols]`` with the entry ``(p * n_rows + dst, p *
    n_cols + src, w)`` for each live edge (padding edges, ``dst ==
    n_rows``, dropped), every row listed; ``bwd`` its transpose, for
    ``d_h`` (None where no gradient is taken).  Each keeps ``perm``, the
    flat edge index ``p * n_edges + e`` of each entry, so that per-edge
    values given at call time (GAT's attention) are put in pack order with
    one gather rather than baked into a pack that would go stale.  With
    ``bwd``, ``amap`` is each ``bwd`` entry's ``fwd`` entry (int32, the
    inverse of ``fwd.perm`` at ``bwd.perm``): GAT's backward reads the
    values of ``A`` in ``A^T``'s order through it."""
    fwd: CsrPack
    bwd: CsrPack | None
    n_parts: int
    n_rows: int
    n_cols: int
    n_edges: int      # edges a partition, padding included
    amap: torch.Tensor | None = None


def edge_packs(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
               n_rows: int, n_cols: int, grad: bool = True,
               long_row: int = LONG_ROW) -> EdgePacks:
    """:class:`EdgePacks` of an edge list ``[(P,) m]`` (``src`` in ``[0,
    n_cols)``, ``dst`` in ``[0, n_rows]``, ``n_rows`` marking padding),
    built with torch ops (:func:`csr_pack_torch`) on the edge list's
    device, once where the edge list goes there (or, for the serving
    engine's subgraphs, once per call); ``grad`` adds ``A^T``, its short
    rows partition by partition (``col_block``), and the entry map
    ``amap``."""
    if src.dim() == 1:
        src, dst, w = src[None], dst[None], w[None]
    n_parts, m = src.shape
    if n_parts * max(m, 1) > ID_LIMIT:
        raise ValueError(f"edge_packs: edge ids are int32: {n_parts} x {m} "
                         f"edges must stay under {ID_LIMIT}")
    p, e = torch.nonzero(dst < n_rows, as_tuple=True)
    rows = p * n_rows + dst[p, e].long()
    cols = p * n_cols + src[p, e].long()
    ids, ws = p * m + e, w[p, e]
    shape = (n_parts * n_rows, n_parts * n_cols)
    fwd = csr_pack_torch(rows, cols, ws, *shape, every_row=True,
                         long_row=long_row, ids=ids)
    bwd = amap = None
    if grad:
        bwd = csr_pack_torch(cols, rows, ws, *shape[::-1], every_row=True,
                             long_row=long_row, ids=ids, col_block=n_rows)
        # edge id -> A entry (only live edges' slots are read), at A^T's ids
        entry = torch.empty(n_parts * m, dtype=torch.int32, device=dst.device)
        entry[fwd.perm.long()] = torch.arange(fwd.nnz, dtype=torch.int32,
                                              device=dst.device)
        amap = entry[bwd.perm.long()].contiguous()
    return EdgePacks(fwd, bwd, n_parts, int(n_rows), int(n_cols), m, amap)


def segment_ids(dst: torch.Tensor, n_rows: int) -> torch.Tensor:
    """``dst [P, M]`` as ids into a flattened ``[P * (n_rows + 1)]`` table:
    row ``n_rows`` of each partition is its spare row."""
    pidx = torch.arange(dst.shape[0], device=dst.device)[:, None]
    return (pidx * (n_rows + 1) + dst.long()).reshape(-1)


def segment_sum(x: torch.Tensor, dst: torch.Tensor, n_rows: int,
                keep_spare: bool = False) -> torch.Tensor:
    """``out[..., r, ...] = sum of x[..., e, ...] over dst[..., e] == r``
    with ``index_add_``, for ``x [m, *rest]`` and ``dst [m]`` or a ``[P,
    ...]`` stack of both.  Entries with ``dst == n_rows`` are padding:
    they land in one spare row a partition, which is sliced off unless
    ``keep_spare`` (the reference's ``segment_sum`` drops them; torch
    would raise on an out-of-range index instead)."""
    batched = dst.dim() == 2
    if not batched:
        x, dst = x[None], dst[None]
    n_parts, rest = dst.shape[0], tuple(x.shape[2:])
    out = x.new_zeros((n_parts * (n_rows + 1),) + rest)
    out.index_add_(0, segment_ids(dst, n_rows),
                   x.reshape((-1,) + rest))
    out = out.view((n_parts, n_rows + 1) + rest)
    if not keep_spare:
        out = out[:, :n_rows]
    return out if batched else out[0]


def coo_spmm(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
             h: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Edge-list aggregation ``out[..., dst[e], :] += w[e] * h[..., src[e], :]``
    with ``index_add_`` (as :func:`segment_sum`), for 2-D operands or a
    ``[P, ...]`` stack; differentiable in ``w`` and ``h``.

    The messages are one ``index_select`` over the flattened ``h`` at ids
    ``p * n_cols + src``, so their backward is an ``index_add_`` into the
    gradient of ``h`` (not the sort-based backward of two-index advanced
    indexing).  Edges with ``dst == n_rows`` are padding: they land in the
    spare row that is sliced off.
    """
    batched = h.dim() == 3
    if not batched:
        src, dst, w, h = src[None], dst[None], w[None], h[None]
    n_parts, n_cols, d = h.shape
    pidx = torch.arange(n_parts, device=h.device)[:, None]
    ids = (pidx * n_cols + src.long()).reshape(-1)
    msgs = h.reshape(-1, d).index_select(0, ids) * \
        w.reshape(-1, 1).to(h.dtype)                                # [P*M, d]
    out = torch.zeros((n_parts * (n_rows + 1), d), dtype=h.dtype,
                      device=h.device)
    out.index_add_(0, segment_ids(dst, n_rows), msgs)
    out = out.view(n_parts, n_rows + 1, d)[:, :n_rows]
    return out if batched else out[0]


def _ell_forward(cols, vals, h, col_chunk, row_end):
    if h.device.type == "cpu":
        if col_chunk is None:
            return _ref.ell_spmm_ref(cols, vals, h)
        return _ref.ell_spmm_chunked_ref(cols, vals, h, col_chunk)
    if col_chunk is None:
        return _ell.ell_spmm(cols, vals, h, row_end)
    return _ell.ell_spmm_chunked(cols, vals, h, col_chunk, row_end)


def _ell_dvals(cols, vals, h, g32):
    """``d_vals[..., i, k] = <g[..., i, :], h[..., cols[..., i, k], :]>``."""
    if g32.device.type == "cpu":
        return _ref.ell_spmm_bwd_ref(cols, vals, h, g32, h.shape[-2],
                                     need_h=False)[0]
    return _ell.ell_spmm_dvals(cols, g32, h.float().contiguous())


def _csr(pack: CsrPack, x: torch.Tensor, out=None) -> torch.Tensor:
    """``A x`` (``out`` None) or ``out + A x`` over 2-D operands: the CSR
    kernel for CUDA tensors (accumulating into ``out`` in place), the plain
    version for CPU tensors."""
    if x.device.type == "cpu":
        return _ref.csr_spmm_ref(pack, x, out)
    x = x.contiguous()
    return (csr_spmm(pack, x) if out is None
            else csr_spmm_accumulate(pack, x, out))


def _refuse_constants(vals_trained: bool, any_trained: bool, row_end,
                      *packs) -> None:
    """``row_end`` and the CSR packs are built once from constant values:
    a trained padding slot past ``row_end`` would be skipped on the card
    and counted on the CPU, and a pack would keep the old values."""
    if row_end is not None and vals_trained:
        raise ValueError("ell_spmm: row_end bounds the slots of constant "
                         "vals; pass no row_end when vals needs a gradient")
    if any_trained and any(p is not None for p in packs):
        raise ValueError("the transposed and tail packs are built from "
                         "constant vals and tail_w; pass no pack when they "
                         "need a gradient")


class EllSpmmFn(torch.autograd.Function):
    """Differentiable blocked-ELL SpMM, ``EllSpmmFn.apply(cols, vals, h,
    col_chunk, row_end, dh_pack)``, for 2-D operands or a ``[P, ...]``
    stack.

    Dispatch goes by the device of ``h``: the CUDA kernels for CUDA
    tensors, the plain versions of :mod:`.ref` for CPU tensors.  The
    backward mirrors the JAX package's ``_spmm_vjp.bwd``: ``d_h = A^T g``
    through the CSR kernel over ``dh_pack`` (:func:`transpose_csr` of
    ``cols``/``vals``; built for the call when none is given) and
    ``d_vals[i, k] = <g[i], h[cols[i, k]]>``, each computed only when
    ``ctx.needs_input_grad`` asks for it, cast to the input's dtype; the
    ``cols`` cotangent is ``None``.  ``row_end`` only bounds the slots the
    forward kernel reads.  ``row_end`` and ``dh_pack`` are computed once
    from constant ``vals``, so they are refused (``ValueError``, on both
    devices) when ``vals`` needs a gradient.
    """

    @staticmethod
    def forward(ctx, cols, vals, h, col_chunk=None, row_end=None,
                dh_pack=None):
        trained = ctx.needs_input_grad[1]
        _refuse_constants(trained, trained, row_end, dh_pack)
        # h is needed only for d_vals: a training step whose vals are
        # constants keeps no layer input alive for the backward
        ctx.save_for_backward(cols, vals, h if trained else None)
        ctx.dh_pack = dh_pack
        ctx.h_meta = (h.shape, h.dtype)
        ctx.scope = current_scope("ell_spmm")
        return _ell_forward(cols, vals, h, col_chunk, row_end)

    @staticmethod
    def backward(ctx, g):
        cols, vals, h = ctx.saved_tensors
        h_shape, h_dtype = ctx.h_meta
        d_vals = d_h = None
        with transpose_scope(ctx.scope):
            g32 = g.float().contiguous()
            if ctx.needs_input_grad[1]:
                d_vals = _ell_dvals(cols, vals, h, g32).to(vals.dtype)
            if ctx.needs_input_grad[2]:
                pack = ctx.dh_pack
                if pack is None:
                    pack = pack_for_call(transpose_csr, cols, vals,
                                         h_shape[-2], device=g.device)
                d_h = _csr(pack, g32.view(-1, g.shape[-1]))
                d_h = d_h.view(h_shape).to(h_dtype)
        return None, d_vals, d_h, None, None, None


def _tail_dw(tail_src, tail_dst, g32, h, n_rows: int) -> torch.Tensor:
    """The tail weights' cotangent ``<g[dst_e], h[src_e]>`` (0 at padding),
    plain torch on both devices, as the JAX package's autodiff of its
    ``segment_sum``."""
    batched = h.dim() == 3
    if not batched:
        tail_src, tail_dst, g32, h = (a[None] for a in
                                      (tail_src, tail_dst, g32, h))
    pidx = torch.arange(h.shape[0], device=h.device)[:, None]
    live = tail_dst < n_rows
    dst = torch.where(live, tail_dst, 0).long()
    dw = (g32[pidx, dst] * h.float()[pidx, tail_src.long()]).sum(-1)
    dw = torch.where(live, dw, 0.0)
    return dw if batched else dw[0]


class HybridSpmmFn(torch.autograd.Function):
    """Differentiable hybrid ELL + COO-tail SpMM, ``HybridSpmmFn.apply(cols,
    vals, tail_src, tail_dst, tail_w, h, row_end, tail_pack, dh_pack)``,
    for 2-D operands or a ``[P, ...]`` stack (tail padding carries
    ``tail_dst == n_rows``).

    Forward: the ELL product, then the tail's CSR (``tail_pack``,
    :func:`tail_csr`) added into it; backward: one CSR product over the
    transposed pack of the whole adjacency (``dh_pack``,
    :func:`transpose_csr` with the tail) for ``d_h``, the ELL ``d_vals``
    and the tail's ``d_tail_w`` where asked for.  On the card the products
    are the CUDA kernels, on the CPU their plain versions.  A pack not
    given is built for the call; a given one (and ``row_end``) is refused
    when ``vals`` or ``tail_w`` needs a gradient, as in
    :class:`EllSpmmFn`.
    """

    @staticmethod
    def forward(ctx, cols, vals, tail_src, tail_dst, tail_w, h,
                row_end=None, tail_pack=None, dh_pack=None):
        trained = ctx.needs_input_grad[1] or ctx.needs_input_grad[4]
        _refuse_constants(ctx.needs_input_grad[1], trained, row_end,
                          tail_pack, dh_pack)
        n_rows, d = cols.shape[-2], h.shape[-1]
        if tail_pack is None:
            tail_pack = pack_for_call(tail_csr, tail_src, tail_dst, tail_w,
                                      n_rows, h.shape[-2], device=h.device)
        out = _ell_forward(cols, vals, h, None, row_end)
        out = _csr(tail_pack, h.reshape(-1, d), out.view(-1, d))
        ctx.save_for_backward(cols, vals, tail_src, tail_dst, tail_w,
                              h if trained else None)
        ctx.dh_pack = dh_pack
        ctx.h_meta = (h.shape, h.dtype)
        ctx.scope = current_scope("hybrid_spmm")
        return out.view(*cols.shape[:-1], d)

    @staticmethod
    def backward(ctx, g):
        cols, vals, tail_src, tail_dst, tail_w, h = ctx.saved_tensors
        h_shape, h_dtype = ctx.h_meta
        d_vals = d_tw = d_h = None
        with transpose_scope(ctx.scope):
            g32 = g.float().contiguous()
            if ctx.needs_input_grad[1]:
                d_vals = _ell_dvals(cols, vals, h, g32).to(vals.dtype)
            if ctx.needs_input_grad[4]:
                d_tw = _tail_dw(tail_src, tail_dst, g32, h, cols.shape[-2]
                                ).to(tail_w.dtype)
            if ctx.needs_input_grad[5]:
                pack = ctx.dh_pack
                if pack is None:
                    pack = pack_for_call(transpose_csr, cols, vals,
                                         h_shape[-2], tail_src, tail_dst,
                                         tail_w, device=g.device)
                d_h = _csr(pack, g32.view(-1, g.shape[-1]))
                d_h = d_h.view(h_shape).to(h_dtype)
        return None, d_vals, None, None, d_tw, d_h, None, None, None


def value_heads(e_vals: torch.Tensor, n_edges: int) -> int:
    """0 for per-edge values of one product, ``e_vals [(P,) n_edges]``;
    ``H`` for GAT's heads, ``e_vals [(P,) n_edges, H]``."""
    if e_vals.shape[-1] == n_edges or e_vals.dim() < 2:
        return 0
    return int(e_vals.shape[-1])


def _valued(pack: CsrPack, e_vals: torch.Tensor,
            heads: int = 0) -> CsrPack:
    """``pack`` with the per-edge values ``e_vals`` in its order (one
    gather through ``perm``, counted in ``_valued.gathers``): ``w [nnz]``,
    or ``[H, nnz]`` per head.  GAT's layer takes none
    (:class:`EdgeAttentionFn`)."""
    _valued.gathers += 1
    if not heads:
        return dataclasses.replace(pack, w=e_vals.reshape(-1).float()
                                   .index_select(0, pack.perm))
    return dataclasses.replace(pack, w=e_vals.reshape(-1, heads).float()
                               .index_select(0, pack.perm).t().contiguous())


_valued.gathers = 0


def _edge_product(kernel, pack: CsrPack, x: torch.Tensor) -> torch.Tensor:
    """``A x`` over an edge pack: ``kernel`` (a write-mode wrapper of
    :mod:`.edge_spmm`) for CUDA tensors, the plain version for CPU
    tensors."""
    if x.device.type == "cpu":
        return _ref.csr_spmm_ref(pack, x)
    return kernel(pack, x)


class EdgeSpmmFn(torch.autograd.Function):
    """The edge-list aggregation over :class:`EdgePacks`,
    ``EdgeSpmmFn.apply(e_vals, h, packs)``: ``out[..., dst[e], :] +=
    v[e] * h[..., src[e], :]`` for ``h [(P,) n_cols, d]``, with ``v`` the
    forward pack's own weights when ``e_vals`` is None (``spmm``) or the
    per-edge values ``e_vals [(P,) n_edges]`` (``spmm_at``), which are
    differentiable.  GAT's heads go as one call: ``e_vals [(P,) n_edges,
    H]`` and ``h [(P,) n_cols, H, dh]`` give ``[(P,) n_rows, H, dh]``, head
    ``z`` weighted by ``e_vals[..., z]`` (:func:`value_heads`).

    Forward: the CSR kernel in write mode over ``packs.fwd``
    (:func:`~.edge_spmm.edge_spmm`); backward: ``d_h`` by the same kernel
    over ``packs.bwd`` (:func:`~.edge_spmm.edge_spmm_dh`) and ``d_e_vals``
    by :func:`~.edge_spmm.edge_dvals`, each only where asked for, with f32
    sums, cast to the input's dtype (0 at padding edges).  Each is one
    launch whatever the number of heads.  On CPU tensors the plain
    versions of :mod:`.ref` over the same packs.  Raises ``ValueError``
    when ``h`` does not fit the packs or a gradient of ``h`` is asked for
    and ``packs.bwd`` is None."""

    @staticmethod
    def forward(ctx, e_vals, h, packs):
        heads = 0 if e_vals is None else value_heads(e_vals, packs.n_edges)
        feat = tuple(h.shape[-2:] if heads else h.shape[-1:])
        lead = tuple(h.shape[:h.dim() - len(feat) - 1])
        if (lead or (1,)) != (packs.n_parts,) or \
                h.shape[len(lead)] != packs.n_cols or \
                (heads and feat[0] != heads) or (
                    e_vals is not None and e_vals.numel() != packs.n_parts
                    * packs.n_edges * max(heads, 1)):
            raise ValueError(
                f"edge packs of {packs.n_parts} x [{packs.n_rows}, "
                f"{packs.n_cols}] over {packs.n_edges} edges do not fit h "
                f"{tuple(h.shape)} and e_vals "
                f"{None if e_vals is None else tuple(e_vals.shape)}")
        if ctx.needs_input_grad[1] and packs.bwd is None:
            raise ValueError("d_h needs the transposed pack: build the "
                             "edge packs with grad=True")
        fwd = packs.fwd if e_vals is None else _valued(packs.fwd, e_vals,
                                                       heads)
        out = _edge_product(_edge.edge_spmm, fwd, h.reshape((-1,) + feat))
        ctx.save_for_backward(e_vals, h if ctx.needs_input_grad[0] else None)
        ctx.packs, ctx.heads, ctx.feat = packs, heads, feat
        ctx.h_meta = (h.shape, h.dtype)
        ctx.scope = current_scope("edge_spmm")
        return out.view(*lead, packs.n_rows, *feat)

    @staticmethod
    def backward(ctx, g):
        e_vals, h = ctx.saved_tensors
        packs, heads, feat = ctx.packs, ctx.heads, ctx.feat
        h_shape, h_dtype = ctx.h_meta
        d_e = d_h = None
        with transpose_scope(ctx.scope):
            g32 = g.float().contiguous().view((-1,) + feat)
            if ctx.needs_input_grad[0]:
                h32 = h.float().contiguous().view((-1,) + feat)
                n_edges = packs.n_parts * packs.n_edges
                if g32.device.type == "cpu":
                    d_e = _ref.edge_dvals_ref(packs.fwd, g32, h32, n_edges)
                else:
                    d_e = _edge.edge_dvals(packs.fwd, g32, h32, n_edges)
                d_e = d_e.view(e_vals.shape).to(e_vals.dtype)
            if ctx.needs_input_grad[1]:
                bwd = packs.bwd if e_vals is None else _valued(packs.bwd,
                                                               e_vals, heads)
                d_h = _edge_product(_edge.edge_spmm_dh, bwd, g32)
                d_h = d_h.view(h_shape).to(h_dtype)
        return d_e, d_h, None


def _need_bwd(packs: EdgePacks) -> None:
    if packs.bwd is None or packs.amap is None:
        raise ValueError("GAT's backward needs the transposed pack and the "
                         "entry map: build the edge packs with grad=True")


class EdgeAttentionFn(torch.autograd.Function):
    """GAT's edge softmax and its aggregation over :class:`EdgePacks`,
    ``EdgeAttentionFn.apply(e_src, e_dst, h, packs)``: for the per-node
    scores ``e_src`` / ``e_dst`` ``[(P,) n_cols, H]`` and heads ``h [(P,)
    n_cols, H, dh]``, ``out[..., i, z, :] = sum over the live edges e into
    i of att[e, z] * h[..., src[e], z, :]`` with ``att`` the softmax over
    i's edges of ``leaky_relu(e_src[src] + e_dst[i], 0.2)``: ``[(P,)
    n_rows, H, dh]``.  A row with no live edge gives zero; padding edges
    are not in the packs.

    On CUDA tensors the forward is two launches, ``edge_softmax_fwd``
    (``att [H, nnz]`` in ``A``'s order) and the CSR kernel over ``A``
    valued by it (``edge_spmm``); the backward ``edge_dvals`` (``d_att``
    in ``A``'s order), ``edge_softmax_bwd`` (``d_e_src``, ``d_e_dst`` and
    ``att`` in ``A^T``'s order, through ``packs.amap``) and the CSR kernel
    over ``A^T`` (``edge_spmm_dh``), each only where
    ``ctx.needs_input_grad`` asks for it.  No per-call gather of the
    values.  On CPU tensors the plain versions of :mod:`.ref` over the
    same packs.  Raises ``ValueError`` when the operands do not fit the
    packs or a gradient is asked for and ``packs.bwd`` is None."""

    @staticmethod
    def forward(ctx, e_src, e_dst, h, packs):
        heads = e_src.shape[-1]
        lead = tuple(h.shape[:-3])
        if (lead or (1,)) != (packs.n_parts,) or h.dim() < 3 or \
                h.shape[-3:-1] != (packs.n_cols, heads) or \
                e_src.shape != h.shape[:-1] or e_dst.shape != e_src.shape:
            raise ValueError(
                f"edge packs of {packs.n_parts} x [{packs.n_rows}, "
                f"{packs.n_cols}] do not fit e_src {tuple(e_src.shape)}, "
                f"e_dst {tuple(e_dst.shape)} and h {tuple(h.shape)}")
        es = e_src.reshape(-1, heads).float().contiguous()
        ed = e_dst.reshape(-1, heads).float().contiguous()
        if h.device.type == "cpu":
            att = _ref.edge_softmax_ref(packs.fwd, es, ed, packs.n_rows,
                                        packs.n_cols)
        else:
            att = _edge.edge_softmax_fwd(packs, es, ed)
        fwd = dataclasses.replace(packs.fwd, w=att)
        dh = h.shape[-1]
        out = _edge_product(_edge.edge_spmm, fwd, h.reshape(-1, heads, dh))
        ctx.save_for_backward(es, ed, h, att)
        ctx.packs = packs
        ctx.meta = (e_src.shape, e_src.dtype, h.dtype)
        ctx.scope = current_scope("edge_attention")
        return out.view(*lead, packs.n_rows, heads, dh)

    @staticmethod
    def backward(ctx, g):
        es, ed, h, att = ctx.saved_tensors
        packs = ctx.packs
        _need_bwd(packs)
        e_shape, e_dtype, h_dtype = ctx.meta
        need_e = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
        need_h = ctx.needs_input_grad[2]
        d_src = d_dst = d_h = None
        heads, dh = h.shape[-2:]
        with transpose_scope(ctx.scope):
            g32 = g.float().contiguous().view(-1, heads, dh)
            cpu = g32.device.type == "cpu"
            d_att = None
            if need_e:
                h32 = h.float().contiguous().view(-1, heads, dh)
                n_edges = packs.n_parts * packs.n_edges
                d_att = (_ref.edge_dvals_ref if cpu else _edge.edge_dvals)(
                    packs.fwd, g32, h32, n_edges, a_order=True)
            if cpu:
                d_src, d_dst, att_t = _ref.edge_softmax_bwd_ref(
                    packs.fwd, packs.bwd, packs.amap, att, d_att, es, ed,
                    packs.n_rows, packs.n_cols, att_t=need_h)
            else:
                d_src, d_dst, att_t = _edge.edge_softmax_bwd(
                    packs, att, es, ed, d_att, att_t=need_h)
            if need_h:
                bwd = dataclasses.replace(packs.bwd, w=att_t)
                d_h = _edge_product(_edge.edge_spmm_dh, bwd, g32)
                d_h = d_h.view(h.shape).to(h_dtype)
            if need_e:
                d_src = d_src.view(e_shape).to(e_dtype)
                d_dst = d_dst.view(e_shape).to(e_dtype)
        return (d_src if ctx.needs_input_grad[0] else None,
                d_dst if ctx.needs_input_grad[1] else None, d_h, None)


def edge_attention(e_src: torch.Tensor, e_dst: torch.Tensor,
                   h: torch.Tensor, packs: EdgePacks | None) -> torch.Tensor:
    """GAT's edge softmax and aggregation ``[(P,) n_rows, H, dh]`` over
    ``packs`` (:func:`edge_packs`): :class:`EdgeAttentionFn`, the
    hand-written kernels on the card (``csrc/edge_softmax.cu`` and the CSR
    kernel), the plain versions on the CPU.  ``e_src`` / ``e_dst``
    ``[(P,) n_cols, H]`` are the per-node scores, ``h [(P,) n_cols, H,
    dh]`` the heads.  Raises ``ValueError`` without packs."""
    if packs is None:
        raise ValueError(f"GAT's edge softmax on {h.device} needs the edge "
                         "list's CSR packs (ops.edge_packs, built once with "
                         "the edge list); this edge list has none")
    if torch.is_grad_enabled() and (e_src.requires_grad or e_dst.requires_grad
                                    or h.requires_grad):
        _need_bwd(packs)
    return EdgeAttentionFn.apply(e_src, e_dst, h, packs)


def edge_spmm(h: torch.Tensor, packs: EdgePacks | None,
              e_vals: torch.Tensor | None = None) -> torch.Tensor:
    """The edge-list aggregation ``[(P,) n_rows, d]`` of ``h [(P,) n_cols,
    d]`` over ``packs`` (:func:`edge_packs`): :class:`EdgeSpmmFn`, the
    hand-written kernels on the card.  ``e_vals`` (``[(P,) n_edges]``)
    replaces the packs' weights; ``e_vals [(P,) n_edges, H]`` with ``h
    [(P,) n_cols, H, dh]`` computes GAT's H heads in one call, ``[(P,)
    n_rows, H, dh]``.  Raises ``ValueError`` without packs: the card has no
    edge-list route but the packs' (``coo_spmm`` is the plain version, for
    CPU tensors)."""
    if packs is None:
        raise ValueError(f"the edge-list aggregation on {h.device} needs its "
                         "CSR packs (ops.edge_packs, built once with the "
                         "edge list); this edge list has none")
    return EdgeSpmmFn.apply(e_vals, h, packs)


def ell_spmm(cols: torch.Tensor, vals: torch.Tensor, h: torch.Tensor,
             col_chunk: int | None = None,
             row_end: torch.Tensor | None = None,
             dh_pack: CsrPack | None = None) -> torch.Tensor:
    """Blocked-ELL SpMM ``[..., n_rows, d]``, differentiable in ``vals`` and
    ``h`` (:class:`EllSpmmFn`): the CUDA kernels for CUDA tensors, the
    plain versions for CPU tensors.

    ``col_chunk`` walks the h rows in chunks of that many rows (the TPU
    kernel's column-chunked variant; the same product).  As in the JAX
    package, a chunk of at least ``n_cols`` rows is the unchunked kernel,
    and a smaller one must divide ``n_cols``.  ``row_end``
    (:func:`ell_row_end` of ``vals``, on ``h``'s device) spares the kernel
    the slots past each row's last live one, and ``dh_pack``
    (:func:`transpose_csr` of ``cols``/``vals``) serves the backward; both
    are for constant ``vals`` and raise ``ValueError`` when ``vals`` needs
    a gradient.
    """
    if col_chunk is not None:
        n_cols = h.shape[-2]
        if col_chunk < 1:
            raise ValueError(f"col_chunk must be >= 1, got {col_chunk}")
        if col_chunk >= n_cols:
            col_chunk = None
        elif n_cols % col_chunk:
            raise ValueError(f"n_cols={n_cols} is not a multiple of "
                             f"col_chunk={col_chunk}; pad the h rows")
    return EllSpmmFn.apply(cols, vals, h, col_chunk, row_end, dh_pack)


def hybrid_spmm(cols: torch.Tensor, vals: torch.Tensor,
                tail_src: torch.Tensor, tail_dst: torch.Tensor,
                tail_w: torch.Tensor, h: torch.Tensor,
                row_end: torch.Tensor | None = None,
                tail_pack: CsrPack | None = None,
                dh_pack: CsrPack | None = None) -> torch.Tensor:
    """ELL SpMM over the regular part plus the COO tail (tail padding
    carries ``tail_dst == n_rows``), differentiable in ``vals``, ``tail_w``
    and ``h`` (:class:`HybridSpmmFn`).  ``tail_pack`` (:func:`tail_csr`)
    and ``dh_pack`` (:func:`transpose_csr` with the tail) are the
    constant packs the kernels walk."""
    return HybridSpmmFn.apply(cols, vals, tail_src, tail_dst, tail_w, h,
                              row_end, tail_pack, dh_pack)


def _gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if src.device.type == "cpu":
        return _ref.gather_rows_ref(src, idx)
    return _gather_mod.gather_rows(src, idx.to(torch.int32))


class GatherRowsFn(torch.autograd.Function):
    """Differentiable row gather, ``GatherRowsFn.apply(src, idx, pack)``:
    ``out[i] = src[idx[i]]`` (a zero row for an id outside ``[0, n_src)``)
    for ``src [n_src, d]`` and a 1-D ``idx``.

    Forward: the gather kernel on the card, :func:`~.ref.gather_rows_ref`
    on the CPU.  Backward: ``d_src = M g`` over ``pack`` = :func:`gather_pack`
    of ``idx`` (built for the call through :func:`pack_for_call` when
    none is given): the CSR kernel in write mode on the card
    (:func:`~.cache_gather.gather_rows_bwd`), :func:`~.ref.csr_spmm_ref`
    over the same pack on the CPU.  A row sent to k consumers sums their k
    rows in a fixed order, with no atomics.  Raises ``ValueError`` when a
    given ``pack`` is not ``[n_src, idx.numel()]``."""

    @staticmethod
    def forward(ctx, src, idx, pack=None):
        if pack is not None and (pack.n_rows, pack.n_cols) != \
                (src.shape[0], idx.numel()):
            raise ValueError(
                f"gather pack [{pack.n_rows}, {pack.n_cols}] does not fit "
                f"src of {src.shape[0]} rows and {idx.numel()} ids")
        ctx.pack = pack
        ctx.src_meta = (src.shape[0], src.dtype)
        ctx.scope = current_scope("gather_rows")
        ctx.save_for_backward(idx if pack is None else None)
        return _gather(src, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        n_src, dtype = ctx.src_meta
        pack = ctx.pack
        with transpose_scope(ctx.scope):
            if pack is None:
                pack = pack_for_call(gather_pack, idx, n_src,
                                     device=g.device)
            if g.device.type == "cpu":
                d_src = _ref.csr_spmm_ref(pack, g)
            else:
                d_src = _gather_mod.gather_rows_bwd(pack, g)
        return d_src.to(dtype), None, None


def gather_rows(src: torch.Tensor, idx: torch.Tensor,
                pack: CsrPack | None = None) -> torch.Tensor:
    """Row gather ``src[idx]`` (``src [n_src, d]``, ``idx`` 1-D; a zero row
    for an id outside ``[0, n_src)``): the CUDA kernel for CUDA tensors
    (with an int32 index), the plain version for CPU tensors.

    While autograd records (``src.requires_grad`` with grad mode on) it is
    :class:`GatherRowsFn`, whose backward walks ``pack`` (:func:`gather_pack`
    of ``idx``, built for the call when not given); otherwise, as under the
    serving engine's ``inference_mode``, the raw call, which pays nothing
    for autograd.  An empty ``idx`` is the raw call too: its gradient is
    zero, and a backward would only write zeros over ``d_src``."""
    if src.requires_grad and torch.is_grad_enabled() and idx.numel():
        return GatherRowsFn.apply(src, idx, pack)
    if src.device.type == "cpu":
        return _ref.gather_rows_ref(src, idx)
    return _gather_mod.gather_rows(src, idx.to(torch.int32))


def pack_rows(src: torch.Tensor, idx: torch.Tensor,
              pack: CsrPack | None = None) -> torch.Tensor:
    """:func:`gather_rows` over an index of any shape, ``[*idx.shape, d]``:
    the JAX package's ``pack_rows`` (the p2p per-peer send pack ``[P, B]``
    -> ``[P, B, d]``).  ``pack`` is :func:`gather_pack` of the flattened
    index.  The JAX package's ``use_pallas`` has no counterpart: the
    dispatch goes by device."""
    out = gather_rows(src, idx.reshape(-1), pack)
    return out.reshape(*idx.shape, src.shape[-1])


def cache_combine(local_rows, local_pos, global_rows, global_pos,
                  recv_rows, recv_pos, n_halo: int) -> torch.Tensor:
    """The three-way tier combine into the halo buffer: plain torch
    indexing on either device, as the JAX package's is a jnp scatter (the
    kernels are the gathers that feed it)."""
    return _ref.cache_combine_ref(local_rows, local_pos, global_rows,
                                  global_pos, recv_rows, recv_pos, n_halo)
