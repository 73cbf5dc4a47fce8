"""Plain PyTorch versions of the port's kernels.

They compute what the CUDA kernels compute, op by op, on any device.  The
kernel wrappers in :mod:`.ops` take them for CPU tensors; the tests and
``chip_smoke.py`` hold the kernels against them.

Out-of-range ids, one contract on both devices: a row id outside ``[0, n)``
reads a zero row.  The gather gives a row of zeros, an ELL slot whose
column lies outside ``[0, n_cols)`` adds nothing to the product and has a
``d_vals`` of 0, as the CUDA kernels do.  The zeros come from
``torch.where``, never from a multiply by a mask, so a NaN or an inf in
the source stays out of them.  (The JAX package's ``jnp.take`` differs:
it wraps a negative id and gives a row of NaN past the end.  No pack that
either package builds carries such an id, so the parity tests never meet
them.)
"""
from __future__ import annotations

import torch

__all__ = ["ell_spmm_ref", "ell_spmm_chunked_ref", "ell_spmm_bwd_ref",
           "csr_spmm_ref", "edge_dvals_ref", "gather_rows_ref",
           "cache_combine_ref", "masked_mean_ref"]

_CSR_CHUNK = 1 << 16   # entries per index_add_ in csr_spmm_ref


def _in_range(ids: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(ok, safe)``: which ids lie in ``[0, n)``, and the ids as int64
    with every other one replaced by 0 (an index torch takes; the caller
    zeroes what it reads with ``torch.where``)."""
    ids = ids.long()
    ok = (ids >= 0) & (ids < n)
    return ok, torch.where(ok, ids, 0)


def ell_spmm_ref(cols: torch.Tensor, vals: torch.Tensor,
                 h: torch.Tensor) -> torch.Tensor:
    """``out[..., i, :] = sum_k vals[..., i, k] * h[..., cols[..., i, k], :]``
    with f32 sums, for 2-D operands or a ``[P, ...]`` stack.

    Walks the slots one at a time and never builds ``h[cols]`` whole: at
    the flickr serving slice's shapes that tensor would take
    4 x 41,522 x 144 x 500 x 4 B, about 48 GB.  The result has ``h``'s
    dtype.  A slot whose column lies outside ``[0, n_cols)`` adds nothing.
    """
    batched = h.dim() == 3
    if not batched:
        cols, vals, h = cols[None], vals[None], h[None]
    n_parts, n_rows, k = cols.shape
    pidx = torch.arange(n_parts, device=h.device)[:, None]
    ok, cols = _in_range(cols, h.shape[1])
    h32 = h.float()
    out = torch.zeros((n_parts, n_rows, h.shape[-1]), dtype=torch.float32,
                      device=h.device)
    for j in range(k):
        out += torch.where(ok[..., j, None],
                           vals[..., j, None].float() * h32[pidx, cols[..., j]],
                           0.0)
    out = out.to(h.dtype)
    return out if batched else out[0]


def ell_spmm_chunked_ref(cols: torch.Tensor, vals: torch.Tensor,
                         h: torch.Tensor, col_chunk: int) -> torch.Tensor:
    """:func:`ell_spmm_ref` accumulated over ``col_chunk``-row chunks of
    ``h``, as the TPU kernel's ``chunk_kernel`` does: chunk ``c`` adds the
    slots whose column lies in ``[c * col_chunk, (c + 1) * col_chunk)``."""
    batched = h.dim() == 3
    if not batched:
        cols, vals, h = cols[None], vals[None], h[None]
    n_parts, n_rows, k = cols.shape
    n_cols = h.shape[1]
    pidx = torch.arange(n_parts, device=h.device)[:, None]
    ok, safe = _in_range(cols, n_cols)
    cols = cols.long()
    h32 = h.float()
    out = torch.zeros((n_parts, n_rows, h.shape[-1]), dtype=torch.float32,
                      device=h.device)
    for lo in range(0, n_cols, col_chunk):
        in_chunk = ok & (cols >= lo) & (cols < lo + col_chunk)
        for j in range(k):
            out += torch.where(
                in_chunk[..., j, None],
                vals[..., j, None].float() * h32[pidx, safe[..., j]], 0.0)
    out = out.to(h.dtype)
    return out if batched else out[0]


def ell_spmm_bwd_ref(cols: torch.Tensor, vals: torch.Tensor,
                     h: torch.Tensor | None, g: torch.Tensor, n_cols: int,
                     need_vals: bool = True, need_h: bool = True):
    """The ELL product's backward, ``(d_vals, d_h)`` in f32, as the JAX
    package's ``_spmm_vjp.bwd`` computes it:

    - ``d_vals[..., i, k] = <g[..., i, :], h[..., cols[..., i, k], :]>`` for
      every slot, padding included;
    - ``d_h = A^T g`` ``[..., n_cols, d]``, ``vals[..., i, k] * g[..., i, :]``
      added into row ``cols[..., i, k]``.

    A slot whose column lies outside ``[0, n_cols)`` has ``d_vals`` 0 and
    adds nothing to ``d_h``.

    An output not asked for is ``None`` (``h`` may then be ``None`` too).
    Walks the slots one at a time, as :func:`ell_spmm_ref` does, and never
    builds ``[n_rows, K, d]`` whole.
    """
    batched = g.dim() == 3
    if not batched:
        cols, vals, g = cols[None], vals[None], g[None]
        h = None if h is None else h[None]
    n_parts, n_rows, k = cols.shape
    d = g.shape[2]
    pidx = torch.arange(n_parts, device=g.device)[:, None]
    ok, cols = _in_range(cols, n_cols)
    g32 = g.float()
    d_vals = d_h = None
    if need_vals:
        h32 = h.float()
        d_vals = torch.stack([(g32 * h32[pidx, cols[..., j]]).sum(-1)
                              for j in range(k)], dim=-1)
        d_vals = torch.where(ok, d_vals, 0.0)
        d_vals = d_vals if batched else d_vals[0]
    if need_h:
        flat = torch.zeros((n_parts * n_cols, d), dtype=torch.float32,
                           device=g.device)
        offs = pidx * n_cols
        for j in range(k):
            flat.index_add_(0, (cols[..., j] + offs).reshape(-1),
                            torch.where(ok[..., j, None],
                                        vals[..., j, None].float() * g32,
                                        0.0).reshape(-1, d))
        d_h = flat.view(n_parts, n_cols, d)
        d_h = d_h if batched else d_h[0]
    return d_vals, d_h


def csr_spmm_ref(pack, x: torch.Tensor,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """``A x`` for a :class:`~.csr_spmm.CsrPack` ``A`` and ``x``
    ``[pack.n_cols, d]``, or ``out + A x`` when ``out`` is given (a new
    tensor), with f32 sums and one rounding to ``x``'s dtype: what the
    kernel's write and accumulate modes compute.  A pack valued per head
    (``w [H, nnz]``) takes ``x [pack.n_cols, H, dh]``: head ``z`` sums
    ``w[z, e] * x[col[e], z]``.  ``index_add_`` over chunks of entries,
    so ``[nnz, d]`` is never built whole (1.3 GB on the serving slice's
    tail at d = 500)."""
    rows = torch.repeat_interleave(
        torch.arange(pack.n_rows, device=x.device),
        (pack.rowptr[1:] - pack.rowptr[:-1]).long())
    col = pack.col.long()
    x32 = x.float()
    # each entry's value(s), broadcast over the features of x's row
    w = pack.w.t()[..., None] if pack.w.dim() == 2 else pack.w[:, None]
    acc = torch.zeros((pack.n_rows,) + tuple(x.shape[1:]),
                      dtype=torch.float32, device=x.device)
    for lo in range(0, pack.nnz, _CSR_CHUNK):
        hi = lo + _CSR_CHUNK
        acc.index_add_(0, rows[lo:hi], w[lo:hi] * x32[col[lo:hi]])
    if out is not None:
        acc = out.float() + acc
    return acc.to(x.dtype)


def edge_dvals_ref(pack, g: torch.Tensor, h: torch.Tensor,
                   n_edges: int) -> torch.Tensor:
    """``d_vals [n_edges]`` f32 for an edge list's forward pack: ``<g[r],
    h[c]>`` at ``pack.perm[k]`` for each entry ``k = (r, c)``, 0 at the
    edges the pack does not hold (padding); per head, ``[n_edges, H]``,
    for ``g [n_rows, H, dh]`` and ``h [n_cols, H, dh]``: what
    ``csrc/edge_dvals.cu`` computes.  Over chunks of entries, so ``[nnz,
    d]`` is never built whole."""
    rows = torch.repeat_interleave(
        torch.arange(pack.n_rows, device=g.device),
        (pack.rowptr[1:] - pack.rowptr[:-1]).long())
    col, perm = pack.col.long(), pack.perm.long()
    g32, h32 = g.float(), h.float()
    out = torch.zeros((n_edges,) + tuple(g.shape[1:-1]), dtype=torch.float32,
                      device=g.device)
    for lo in range(0, pack.nnz, _CSR_CHUNK):
        hi = lo + _CSR_CHUNK
        out[perm[lo:hi]] = (g32[rows[lo:hi]] * h32[col[lo:hi]]).sum(-1)
    return out


def gather_rows_ref(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i] = src[idx[i]]``, a row of zeros where ``idx[i]`` lies
    outside ``[0, n_src)``; differentiable in ``src``."""
    ok, safe = _in_range(idx, src.shape[0])
    if not src.shape[0]:
        return src.new_zeros((idx.shape[0],) + tuple(src.shape[1:]))
    return torch.where(ok[:, None], src[safe], 0)


def cache_combine_ref(local_rows: torch.Tensor, local_pos: torch.Tensor,
                      global_rows: torch.Tensor, global_pos: torch.Tensor,
                      recv_rows: torch.Tensor, recv_pos: torch.Tensor,
                      n_halo: int) -> torch.Tensor:
    """Scatter three row sources into one ``[n_halo, d]`` halo buffer.

    Position arrays index into the halo buffer; each halo slot is covered
    by exactly one source (a plan property).  Any source may be empty
    (a size-0 leading dim); the buffer takes the width, dtype and device
    of the first non-empty one, in the order local, global, received."""
    first = next((r for r in (local_rows, global_rows) if r.numel()),
                 recv_rows)
    out = torch.zeros((n_halo, first.shape[-1]), dtype=first.dtype,
                      device=first.device)
    for rows, pos in ((local_rows, local_pos), (global_rows, global_pos),
                      (recv_rows, recv_pos)):
        if rows.shape[0]:
            out[pos.long()] = rows.to(out.dtype)
    return out


def masked_mean_ref(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Row-masked column mean: the mean over the rows where ``mask`` is 1
    (zeros when no row is)."""
    m = mask.to(x.dtype)[:, None]
    return (x * m).sum(0) / torch.clamp(m.sum(), min=1.0)
