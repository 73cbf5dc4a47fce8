"""The edge-list aggregation on the card: ``csrc/csr_spmm.cu`` over an edge
list's CSR packs, and ``csrc/edge_dvals.cu``.

- :func:`edge_spmm` — ``A x`` over the forward pack (the CSR kernel's write
  mode): the ``edges`` backend's forward, GAT's per-head ``spmm_at``, the
  1.5D strategy's chunk and the serving engine's fresh recompute;
- :func:`edge_spmm_dh` — ``d_h = A^T g``, the same kernel over the
  transposed pack;
- :func:`edge_dvals` — ``d_vals[e] = <g[row(e)], h[col(e)]>`` for every
  edge of the forward pack, written back to edge order through its
  ``perm`` (the per-edge values' cotangent: GAT's attention gradient).

The JAX package computes all three with ``jax.ops.segment_sum`` and its
autodiff (``src/repro/models/gnn.py:99-105``,
``src/repro/dist/strategy_15d.py:327-328``), no ``pallas_call``; the port's
plain version is :func:`~.ops.coo_spmm`, for CPU tensors.  The packs
(:func:`~.ops.edge_packs`), the autograd Function
(:class:`~.ops.EdgeSpmmFn`) and the dispatch by device live in
:mod:`.ops`, the plain versions of the kernels in :mod:`.ref`.  Each
wrapper checks its operands, launches on the current stream of the
operands' device without synchronising, raises if the launch fails, and
adds one to its ``launches`` counter per call that launches.
"""
from __future__ import annotations

import ctypes

import torch

from .csr_spmm import _INT_FIELDS, ID_LIMIT, CsrPack, write_mode
from .ell_spmm import _check, _entry, _launch, ell_launch_config

__all__ = ["edge_spmm", "edge_spmm_dh", "edge_dvals", "dvals_config"]

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# (rowptr, col, perm, short_rows, n_short, seg, n_seg, long_rows,
#  long_seg_ptr, n_long, g, h, dvals, d, vec, lanes, nv, device, stream)
_ARGTYPES = ([_PTR] * 4 + [_INT, _PTR, _INT] + [_PTR] * 2 + [_INT]
             + [_PTR] * 3 + [_INT] * 5 + [_PTR])
# a lane holds at most this many vectors of a stripe (csrc/edge_dvals.cu
# builds 1, 2 and 4)
_MAX_NV = 4


def edge_spmm(pack: CsrPack, x: torch.Tensor) -> torch.Tensor:
    """``A x`` ``[pack.n_rows, d]`` over an edge list's forward pack, f32
    or bf16 ``x`` with f32 sums (:func:`~.csr_spmm.csr_spmm`'s write mode,
    counted here)."""
    out, launched = write_mode("edge_spmm", pack, x.contiguous())
    edge_spmm.launches += int(launched)
    return out


def edge_spmm_dh(pack: CsrPack, g: torch.Tensor) -> torch.Tensor:
    """``d_h = A^T g`` over an edge list's transposed pack (the same
    kernel, counted here)."""
    out, launched = write_mode("edge_spmm_dh", pack, g.contiguous())
    edge_spmm_dh.launches += int(launched)
    return out


def dvals_config(d: int, addr_bits: int) -> tuple[int, int, int]:
    """``(vec, lanes, nv)`` of the ``d_vals`` kernel for f32 rows of
    ``d``: ``vec`` floats a load as the forward kernels pick them
    (``addr_bits`` the OR of the g and h base addresses), ``lanes`` a
    power of two covering the row's vectors (at most 32), and ``nv``
    vectors a lane; a row wider than ``lanes * nv * vec`` is walked in
    stripes of that width."""
    vec = ell_launch_config(d, 4, addr_bits)[0]
    n_vec = max(1, d // vec)
    lanes = 1
    while lanes < min(n_vec, 32):
        lanes *= 2
    nv = 1
    while nv < _MAX_NV and lanes * nv < n_vec:
        nv *= 2
    return vec, lanes, nv


def edge_dvals(pack: CsrPack, g: torch.Tensor, h: torch.Tensor,
               n_edges: int) -> torch.Tensor:
    """``d_vals [n_edges]`` f32: ``<g[r], h[c]>`` at ``pack.perm[k]`` for
    each entry ``k = (r, c)`` of the forward pack, 0 at the edges the pack
    does not hold (padding).  ``g [pack.n_rows, d]`` and ``h [pack.n_cols,
    d]`` f32.  Each value is one warp's sum in a fixed order: two launches
    give the same bits."""
    named = {f: getattr(pack, f) for f in _INT_FIELDS}
    if pack.perm is None:
        raise ValueError("edge_dvals kernel: the pack carries no perm (build "
                         "it with ops.edge_packs)")
    _check("edge_dvals", {"g": g, "h": h, "perm": pack.perm, **named},
           g.device)
    if any(named[f].dtype != torch.int32 for f in named) or \
            pack.perm.dtype != torch.int32:
        raise TypeError("edge_dvals kernel: the pack's ids must be int32")
    if g.dtype != torch.float32 or h.dtype != torch.float32 or \
            g.dim() != 2 or h.dim() != 2 or g.shape[1] != h.shape[1] or \
            g.shape[0] != pack.n_rows or h.shape[0] != pack.n_cols:
        raise TypeError(f"edge_dvals kernel: g [{pack.n_rows}, d] and h "
                        f"[{pack.n_cols}, d] float32 expected, got "
                        f"{g.dtype} {tuple(g.shape)} and {h.dtype} "
                        f"{tuple(h.shape)}")
    if not pack.nnz <= n_edges <= ID_LIMIT:
        raise ValueError(f"edge_dvals kernel: {n_edges} edges for a pack of "
                         f"{pack.nnz} entries (ids are int32)")
    d = g.shape[1]
    alloc = torch.empty if pack.nnz == n_edges and d else torch.zeros
    out = alloc(n_edges, dtype=torch.float32, device=g.device)
    n_seg, n_short = pack.seg.shape[0], pack.short_rows.shape[0]
    if not d or not (n_seg or n_short):
        return out
    vec, lanes, nv = dvals_config(d, g.data_ptr() | h.data_ptr())
    fn = _entry("edge_dvals", "edge_dvals_f32", _ARGTYPES)
    _launch(fn, g.get_device(), pack.rowptr.data_ptr(), pack.col.data_ptr(),
            pack.perm.data_ptr(), pack.short_rows.data_ptr(), n_short,
            pack.seg.data_ptr(), n_seg, pack.long_rows.data_ptr(),
            pack.long_seg_ptr.data_ptr(), pack.long_rows.shape[0],
            g.data_ptr(), h.data_ptr(), out.data_ptr(), d, vec, lanes, nv)
    edge_dvals.launches += 1
    return out


for _fn in (edge_spmm, edge_spmm_dh, edge_dvals):
    _fn.launches = 0
