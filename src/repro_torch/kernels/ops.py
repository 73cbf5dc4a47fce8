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
them built for its call (:func:`pack_for_call`).  The ``edges`` backend's
:func:`coo_spmm` stays plain torch, as the JAX package's ``segment_sum``
backend.

The row gather (:func:`gather_rows`, and :func:`pack_rows` over any index
shape) is differentiable in ``src`` through :class:`GatherRowsFn` whenever
autograd records: its backward is the CSR kernel in write mode over the
transposed index map (:func:`gather_pack`), so no path meets PyTorch's
sort-based indexing backward.  Outside autograd it is the raw kernel call.

Out-of-range ids have one contract on both devices: an id outside
``[0, n)`` reads a zero row, in the gather and in the ELL slots (their
columns), as the CUDA kernels do and as :mod:`.ref` does with
``torch.where``; a CSR pack refuses such entries (:func:`csr_pack`), and
:func:`gather_pack` leaves them out.  The JAX package's ``jnp.take``
wraps a negative id and gives a row of NaN past the end; no pack built by
either package carries such an id.
"""
from __future__ import annotations

import numpy as np
import torch

from . import cache_gather as _gather_mod
from . import ell_spmm as _ell
from . import ref as _ref
from .csr_spmm import ID_LIMIT, CsrPack, csr_spmm, csr_spmm_accumulate

__all__ = ["ell_pack", "ell_pack_hybrid", "ell_row_end", "LONG_ROW",
           "csr_pack", "transpose_csr", "tail_csr", "pack_for_call",
           "gather_pack", "coo_spmm", "EllSpmmFn", "HybridSpmmFn",
           "GatherRowsFn", "ell_spmm", "hybrid_spmm", "gather_rows",
           "pack_rows"]

# A CSR row with more entries than this is long: the kernel cuts it into
# segments of at most this many entries, one block each (PERF.md: the
# `--sweep` of chip_smoke.py over 64-1024).
LONG_ROW = 256


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


def csr_pack(rows: np.ndarray, cols: np.ndarray, w: np.ndarray,
             n_rows: int, n_cols: int, every_row: bool,
             long_row: int = LONG_ROW, device="cpu") -> CsrPack:
    """The entries ``(rows[e], cols[e], w[e])`` of an ``[n_rows, n_cols]``
    matrix as a :class:`~.csr_spmm.CsrPack` on ``device``: sorted by row,
    then column; rows of more than ``long_row`` entries cut into equal
    segments of at most ``long_row``; the other rows listed longest first,
    empty ones too when ``every_row``.  Ids are int32: raises past
    :data:`~.csr_spmm.ID_LIMIT`."""
    rows = np.asarray(rows, np.int64).ravel()
    cols = np.asarray(cols, np.int64).ravel()
    w = np.asarray(w, np.float32).ravel()
    if max(n_rows + 1, n_cols, rows.size) > ID_LIMIT:
        raise ValueError(f"csr_pack: ids are int32: {n_rows} rows, {n_cols} "
                         f"columns and {rows.size} entries must stay under "
                         f"{ID_LIMIT}")
    if long_row < 1:
        raise ValueError(f"csr_pack: long_row must be >= 1, got {long_row}")
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
    short = short[np.argsort(-counts[short], kind="stable")]

    def put(a, dtype=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a), device=device
                               ).to(dtype)
    return CsrPack(rowptr=put(rowptr), col=put(cols),
                   w=put(w, torch.float32), short_rows=put(short),
                   seg=put(seg.reshape(-1, 2)), long_rows=put(long_rows),
                   long_seg_ptr=put(long_seg_ptr), n_rows=int(n_rows),
                   n_cols=int(n_cols), long_row=int(long_row),
                   every_row=bool(every_row))


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
    row listed: :func:`~.csr_spmm.csr_spmm` of it and ``g`` (``[P * n_rows,
    d]``) is ``d_h``."""
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
                    every_row=True, long_row=long_row, device=device)


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


def coo_spmm(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
             h: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Edge-list aggregation ``out[..., dst[e], :] += w[e] * h[..., src[e], :]``
    with ``index_add_``, for 2-D operands or a ``[P, ...]`` stack.

    Edges with ``dst == n_rows`` are padding: they land in one spare row
    that is sliced off (the reference's segment sum drops them; torch
    would raise on an out-of-range index instead).
    """
    batched = h.dim() == 3
    if not batched:
        src, dst, w, h = src[None], dst[None], w[None], h[None]
    n_parts, d = h.shape[0], h.shape[-1]
    pidx = torch.arange(n_parts, device=h.device)[:, None]
    msgs = h[pidx, src.long()] * w[..., None].to(h.dtype)       # [P, M, d]
    flat = (pidx * (n_rows + 1) + dst.long()).reshape(-1)
    out = torch.zeros((n_parts * (n_rows + 1), d), dtype=h.dtype,
                      device=h.device)
    out.index_add_(0, flat, msgs.reshape(-1, d))
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
        return _ell_forward(cols, vals, h, col_chunk, row_end)

    @staticmethod
    def backward(ctx, g):
        cols, vals, h = ctx.saved_tensors
        h_shape, h_dtype = ctx.h_meta
        g32 = g.float().contiguous()
        d_vals = d_h = None
        if ctx.needs_input_grad[1]:
            d_vals = _ell_dvals(cols, vals, h, g32).to(vals.dtype)
        if ctx.needs_input_grad[2]:
            pack = ctx.dh_pack
            if pack is None:
                pack = pack_for_call(transpose_csr, cols, vals, h_shape[-2],
                                     device=g.device)
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
        return out.view(*cols.shape[:-1], d)

    @staticmethod
    def backward(ctx, g):
        cols, vals, tail_src, tail_dst, tail_w, h = ctx.saved_tensors
        h_shape, h_dtype = ctx.h_meta
        g32 = g.float().contiguous()
        d_vals = d_tw = d_h = None
        if ctx.needs_input_grad[1]:
            d_vals = _ell_dvals(cols, vals, h, g32).to(vals.dtype)
        if ctx.needs_input_grad[4]:
            d_tw = _tail_dw(tail_src, tail_dst, g32, h, cols.shape[-2]
                            ).to(tail_w.dtype)
        if ctx.needs_input_grad[5]:
            pack = ctx.dh_pack
            if pack is None:
                pack = pack_for_call(transpose_csr, cols, vals, h_shape[-2],
                                     tail_src, tail_dst, tail_w,
                                     device=g.device)
            d_h = _csr(pack, g32.view(-1, g.shape[-1]))
            d_h = d_h.view(h_shape).to(h_dtype)
        return None, d_vals, None, None, d_tw, d_h, None, None, None



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
        ctx.save_for_backward(idx if pack is None else None)
        return _gather(src, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        n_src, dtype = ctx.src_meta
        pack = ctx.pack
        if pack is None:
            pack = pack_for_call(gather_pack, idx, n_src, device=g.device)
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
