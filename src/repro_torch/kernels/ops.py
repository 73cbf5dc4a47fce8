"""The port's aggregation and gather ops: numpy ELL packing, and the
dispatch by tensor device between the CUDA kernels and their plain
versions.

A CPU tensor takes the plain version in :mod:`.ref`; a CUDA tensor
launches the hand-written kernel (:mod:`.ell_spmm`, :mod:`.cache_gather`),
whose wrapper raises on anything it does not take.  There is no fallback
from the card to the plain version.  The ELL product is differentiable on
both devices through one autograd Function; the COO tail of the hybrid
product stays plain torch autograd (``index_add_``), as the JAX package's
tail is a plain ``segment_sum``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import cache_gather as _gather
from . import ell_spmm as _ell
from . import ref as _ref

__all__ = ["ell_pack", "ell_pack_hybrid", "ell_row_end", "coo_spmm",
           "ell_spmm", "hybrid_spmm", "gather_rows"]


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


def ell_spmm(cols: torch.Tensor, vals: torch.Tensor, h: torch.Tensor,
             col_chunk: int | None = None,
             row_end: torch.Tensor | None = None) -> torch.Tensor:
    """Blocked-ELL SpMM ``[..., n_rows, d]``, differentiable in ``vals`` and
    ``h`` (:class:`~.ell_spmm.EllSpmmFn`): the CUDA kernels for CUDA
    tensors, the plain versions for CPU tensors.

    ``col_chunk`` walks the h rows in chunks of that many rows (the TPU
    kernel's column-chunked variant; the same product).  As in the JAX
    package, a chunk of at least ``n_cols`` rows is the unchunked kernel,
    and a smaller one must divide ``n_cols``.  ``row_end``
    (:func:`ell_row_end` of ``vals``, on ``h``'s device) spares the kernel
    the slots past each row's last live one; it is for constant ``vals``
    and raises ``ValueError`` when ``vals`` needs a gradient.
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
    return _ell.EllSpmmFn.apply(cols, vals, h, col_chunk, row_end)


def hybrid_spmm(cols: torch.Tensor, vals: torch.Tensor,
                tail_src: torch.Tensor, tail_dst: torch.Tensor,
                tail_w: torch.Tensor, h: torch.Tensor,
                row_end: torch.Tensor | None = None) -> torch.Tensor:
    """ELL SpMM over the regular part plus the COO tail's ``index_add_``
    (tail padding carries ``tail_dst == n_rows``)."""
    out = ell_spmm(cols, vals, h, row_end=row_end)
    if tail_src.shape[-1]:
        out = out + coo_spmm(tail_src, tail_dst, tail_w, h, cols.shape[-2])
    return out


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather ``src[idx]``: the CUDA kernel for CUDA tensors (with an
    int32 index), the plain version for CPU tensors."""
    if src.device.type == "cpu":
        return _ref.gather_rows_ref(src, idx)
    return _gather.gather_rows(src, idx.to(torch.int32))
