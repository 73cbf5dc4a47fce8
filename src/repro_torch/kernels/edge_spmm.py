"""The edge-list aggregation on the card: ``csrc/csr_spmm.cu`` over an edge
list's CSR packs, ``csrc/edge_dvals.cu``, and GAT's edge softmax
(``csrc/edge_softmax.cu``).

- :func:`edge_spmm` — ``A x`` over the forward pack (the CSR kernel's write
  mode): the ``edges`` backend's forward, GAT's ``spmm_at`` (all heads in
  one launch), the 1.5D strategy's chunk and the serving engine's fresh
  recompute;
- :func:`edge_spmm_dh` — ``d_h = A^T g``, the same kernel over the
  transposed pack;
- :func:`edge_dvals` — ``d_vals[e] = <g[row(e)], h[col(e)]>`` for every
  edge of the forward pack (per head for ``[n, H, dh]`` rows, one launch
  for all heads), written back to edge order through its ``perm`` (the
  per-edge values' cotangent: GAT's attention gradient), or in the pack's
  own order (``a_order``);
- :func:`edge_softmax_fwd` — GAT's attention ``[H, nnz]`` in the forward
  pack's order, the softmax over each row of ``leaky_relu(e_src[src] +
  e_dst[dst], 0.2)``, all heads in one launch;
- :func:`edge_softmax_bwd` — its backward: the scores' cotangents
  ``d_e_src`` and ``d_e_dst`` from the attention's (a walk of ``A``'s rows,
  then of ``A^T``'s through the packs' entry map ``amap``), and the
  attention in ``A^T``'s order for ``d_h``.

The JAX package computes the first three with ``jax.ops.segment_sum`` and
its autodiff (``src/repro/models/gnn.py:99-105``,
``src/repro/dist/strategy_15d.py:327-328``) and the softmax with
``segment_max``, ``exp``, ``segment_sum`` and autodiff
(``src/repro/models/gnn.py:278-283``), no ``pallas_call``; the port's plain
versions are :func:`~.ops.coo_spmm`, :func:`~.ref.edge_softmax_ref` and
:func:`~.ref.edge_softmax_bwd_ref`, for CPU tensors.  The packs
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

__all__ = ["edge_spmm", "edge_spmm_dh", "edge_dvals", "dvals_config",
           "edge_softmax_fwd", "edge_softmax_bwd"]

_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (rowptr, col, perm, short_rows, n_short, seg, n_seg, long_rows,
#  long_seg_ptr, n_long, g, h, dvals, d, heads, es, zs, vec, lanes, nv, q,
#  device, stream)
_ARGTYPES = ([_PTR] * 4 + [_INT, _PTR, _INT] + [_PTR] * 2 + [_INT]
             + [_PTR] * 3 + [_INT] * 2 + [_I64] * 2 + [_INT] * 5 + [_PTR])
# edge_softmax.cu: a pack's row lists (rowptr, col, short_rows,
# short_span, runs, n_runs, run_warps, seg, seg_long, n_seg, long_rows,
# long_seg_ptr, n_long)
_ROWS_ARGTYPES = ([_PTR] * 5 + [_INT] * 2 + [_PTR] * 2 + [_INT] + [_PTR] * 2
                  + [_INT])
# (A's row lists, e_src, e_dst, att, part, nnz, heads, n_rows, n_cols,
#  vec, device, stream)
_SOFTMAX_FWD_ARGTYPES = (_ROWS_ARGTYPES + [_PTR] * 4 + [_I64] + [_INT] * 5
                         + [_PTR])
# (A's row lists, A^T's, amap, e_src, e_dst, att, d_att, dxatt, part,
#  d_e_src, d_e_dst, att_t, nnz, heads, n_rows, n_cols, vec, device,
#  stream)
_SOFTMAX_BWD_ARGTYPES = (_ROWS_ARGTYPES * 2 + [_PTR] * 10 + [_I64]
                         + [_INT] * 5 + [_PTR])
# the most heads edge_softmax.cu is built for
MAX_SOFTMAX_HEADS = 16
# a lane holds at most this many vectors of a stripe (csrc/edge_dvals.cu
# builds 1, 2 and 4)
_MAX_NV = 4
# the one-pass walk over all heads: lanes a head it is built for (16-byte
# words, 32 lanes a row of 32, 64 or 128 vectors)
_FUSED_Q = (4, 8, 16, 32)
_FUSED_ROW_VECTORS = (32, 64, 128)


def edge_spmm(pack: CsrPack, x: torch.Tensor) -> torch.Tensor:
    """``A x`` ``[pack.n_rows, d]`` over an edge list's forward pack, f32
    or bf16 ``x`` with f32 sums (:func:`~.csr_spmm.csr_spmm`'s write mode,
    counted here); ``[pack.n_rows, H, dh]`` for ``x [pack.n_cols, H, dh]``
    and a pack valued per head (``w [H, nnz]``), in one launch."""
    out, launched = write_mode("edge_spmm", pack, x.contiguous())
    edge_spmm.launches += int(launched)
    return out


def edge_spmm_dh(pack: CsrPack, g: torch.Tensor) -> torch.Tensor:
    """``d_h = A^T g`` over an edge list's transposed pack (the same
    kernel, counted here)."""
    out, launched = write_mode("edge_spmm_dh", pack, g.contiguous())
    edge_spmm_dh.launches += int(launched)
    return out


def dvals_config(d: int, addr_bits: int, heads: int = 1,
                 one_pass: bool = True) -> tuple[int, int, int, int]:
    """``(vec, lanes, nv, q)`` of the ``d_vals`` kernel for f32 rows of
    ``heads`` heads of ``d``: ``vec`` floats a load as the forward
    kernels pick them (``addr_bits`` the OR of the g and h base addresses
    and the row's bytes).  Where a row of several heads is 32, 64 or 128
    16-byte words and a head 4 to 32 of them (GAT's 4 heads of 64: 64
    words, 16 a head), one pass over the entries serves every head: 32
    lanes cover the row, ``q`` lanes a head, ``nv`` vectors a lane.
    Otherwise, or without ``one_pass`` (a sweep of the variants), head by
    head (``q`` 0): ``lanes`` a power of two covering a head's vectors (at
    most 32) and ``nv`` vectors a lane; a head wider than ``lanes * nv *
    vec`` is walked in stripes of that width."""
    vec = ell_launch_config(d, 4, addr_bits)[0]
    n_vec = max(1, d // vec)
    if one_pass and heads > 1 and vec == 4 and \
            n_vec in _FUSED_Q and heads * n_vec in _FUSED_ROW_VECTORS:
        return vec, 32, heads * n_vec // 32, n_vec
    lanes = 1
    while lanes < min(n_vec, 32):
        lanes *= 2
    nv = 1
    while nv < _MAX_NV and lanes * nv < n_vec:
        nv *= 2
    return vec, lanes, nv, 0


def edge_dvals(pack: CsrPack, g: torch.Tensor, h: torch.Tensor,
               n_edges: int, a_order: bool = False) -> torch.Tensor:
    """``d_vals [n_edges]`` f32: ``<g[r], h[c]>`` at ``pack.perm[k]`` for
    each entry ``k = (r, c)`` of the forward pack, 0 at the edges the pack
    does not hold (padding).  ``g [pack.n_rows, d]`` and ``h [pack.n_cols,
    d]`` f32; with heads, ``g [pack.n_rows, H, dh]`` and ``h [pack.n_cols,
    H, dh]`` give ``d_vals [n_edges, H]``, every head in one launch.  With
    ``a_order`` the values stay in the pack's order, ``[nnz]`` or ``[H,
    nnz]`` (head-major, as :func:`edge_softmax_bwd` reads them), and need
    no ``perm``.  Each value is one lane's sum in a fixed order: two
    launches give the same bits."""
    out, launched = _dvals(pack, g, h, n_edges, a_order=a_order)
    edge_dvals.launches += int(launched)
    return out


def _dvals(pack: CsrPack, g: torch.Tensor, h: torch.Tensor, n_edges: int,
           one_pass: bool = True, a_order: bool = False
           ) -> tuple[torch.Tensor, bool]:
    """:func:`edge_dvals`' check and launch, uncounted: ``(d_vals,
    launched)``; ``one_pass`` as :func:`dvals_config` takes it,
    ``a_order`` as :func:`edge_dvals`."""
    named = {f: getattr(pack, f) for f in _INT_FIELDS}
    if not a_order:
        if pack.perm is None:
            raise ValueError("edge_dvals kernel: the pack carries no perm "
                             "(build it with ops.edge_packs)")
        named["perm"] = pack.perm
    _check("edge_dvals", {"g": g, "h": h, **named}, g.device)
    if any(named[f].dtype != torch.int32 for f in named):
        raise TypeError("edge_dvals kernel: the pack's ids must be int32")
    if g.dtype != torch.float32 or h.dtype != torch.float32 or \
            g.dim() not in (2, 3) or h.dim() != g.dim() or \
            g.shape[1:] != h.shape[1:] or g.shape[0] != pack.n_rows or \
            h.shape[0] != pack.n_cols:
        raise TypeError(f"edge_dvals kernel: g [{pack.n_rows}, (H,) d] and "
                        f"h [{pack.n_cols}, (H,) d] float32 expected, got "
                        f"{g.dtype} {tuple(g.shape)} and {h.dtype} "
                        f"{tuple(h.shape)}")
    if not pack.nnz <= n_edges <= ID_LIMIT:
        raise ValueError(f"edge_dvals kernel: {n_edges} edges for a pack of "
                         f"{pack.nnz} entries (ids are int32)")
    heads = g.shape[1] if g.dim() == 3 else 1
    d = g.shape[-1]
    if a_order:
        # [nnz] or [H, nnz]: entry k, head z at k + z * nnz
        out = (torch.zeros if not d else torch.empty)(
            tuple(g.shape[1:-1]) + (pack.nnz,), dtype=torch.float32,
            device=g.device)
        es, zs = 1, pack.nnz
    else:
        alloc = torch.empty if pack.nnz == n_edges and d else torch.zeros
        out = alloc((n_edges,) + tuple(g.shape[1:-1]), dtype=torch.float32,
                    device=g.device)
        es, zs = heads, 1
    n_seg, n_short = pack.seg.shape[0], pack.short_rows.shape[0]
    if not d or not heads or not (n_seg or n_short):
        return out, False
    vec, lanes, nv, q = dvals_config(d, g.data_ptr() | h.data_ptr()
                                     | heads * d * 4, heads, one_pass)
    fn = _entry("edge_dvals", "edge_dvals_f32", _ARGTYPES)
    _launch(fn, g.get_device(), pack.rowptr.data_ptr(), pack.col.data_ptr(),
            None if a_order else pack.perm.data_ptr(),
            pack.short_rows.data_ptr(), n_short,
            pack.seg.data_ptr(), n_seg, pack.long_rows.data_ptr(),
            pack.long_seg_ptr.data_ptr(), pack.long_rows.shape[0],
            g.data_ptr(), h.data_ptr(), out.data_ptr(), d, heads, es, zs,
            vec, lanes, nv, q)
    return out, True


def _scores(kernel: str, packs, e_src: torch.Tensor,
            e_dst: torch.Tensor) -> int:
    """Checks the per-node scores ``e_src`` / ``e_dst`` ``[P * n_cols,
    H]`` f32 against ``packs`` and the card; returns ``H``."""
    pack = packs.fwd
    named = {f: getattr(pack, f) for f in _INT_FIELDS}
    _check(kernel, {"e_src": e_src, "e_dst": e_dst, **named}, e_src.device)
    if any(t.dtype != torch.int32 for t in named.values()):
        raise TypeError(f"{kernel} kernel: the pack's ids must be int32")
    want = (packs.n_parts * packs.n_cols,)
    if e_src.dtype != torch.float32 or e_dst.dtype != torch.float32 or \
            e_src.dim() != 2 or e_src.shape != e_dst.shape or \
            e_src.shape[:1] != want:
        raise TypeError(f"{kernel} kernel: e_src and e_dst [{want[0]}, H] "
                        f"float32 expected, got {e_src.dtype} "
                        f"{tuple(e_src.shape)} and {e_dst.dtype} "
                        f"{tuple(e_dst.shape)}")
    heads = e_src.shape[1]
    if not 1 <= heads <= MAX_SOFTMAX_HEADS:
        raise ValueError(f"{kernel} kernel: 1 to {MAX_SOFTMAX_HEADS} heads, "
                         f"got {heads}")
    return heads


def _rows_args(pack: CsrPack) -> tuple:
    """A pack's row lists as ``edge_softmax.cu`` takes them: the CSR, the
    short rows with their entry ranges and runs, the long rows with their
    segments."""
    return (pack.rowptr.data_ptr(), pack.col.data_ptr(),
            pack.short_rows.data_ptr(), pack.short_span.data_ptr(),
            pack.runs.data_ptr(), pack.runs.shape[0] - 1, pack.run_warps,
            pack.seg.data_ptr(), pack.seg_long.data_ptr(), pack.seg.shape[0],
            pack.long_rows.data_ptr(), pack.long_seg_ptr.data_ptr(),
            pack.long_rows.shape[0])


def _vec(heads: int, *ts) -> int:
    """1 where a row of ``heads`` floats is 16-byte words (4, 8 or 16
    heads) and every base address is 16-byte aligned."""
    return int(heads in (4, 8, 16) and all(t.data_ptr() % 16 == 0
                                           for t in ts))


def edge_softmax_fwd(packs, e_src: torch.Tensor,
                     e_dst: torch.Tensor) -> torch.Tensor:
    """GAT's attention ``att [H, nnz]`` f32 in the order of ``packs.fwd``
    (the per-head ``w`` of :func:`edge_spmm`): for the entry ``k`` of row
    ``r = p * n_rows + i`` and column ``c``, ``logit = leaky_relu(e_src[c]
    + e_dst[p * n_cols + i], 0.2)``, softmaxed over the row (its max
    subtracted, its sum clamped at 1e-9), every head in one launch.
    ``e_src`` and ``e_dst`` are ``[P * n_cols, H]`` f32 (the
    :class:`~.ops.EdgePacks` ``packs``' stacked per-node scores).  Each
    sum has a fixed order: two launches give the same bits."""
    heads = _scores("edge_softmax_fwd", packs, e_src, e_dst)
    pack = packs.fwd
    att = torch.empty((heads, pack.nnz), dtype=torch.float32,
                      device=e_src.device)
    if not pack.nnz:
        return att
    # each long row segment's (max, sum) per head
    part = torch.empty((pack.seg.shape[0], 2, heads), dtype=torch.float32,
                       device=e_src.device)
    fn = _entry("edge_softmax", "edge_softmax_fwd_f32", _SOFTMAX_FWD_ARGTYPES)
    _launch(fn, e_src.get_device(), *_rows_args(pack), e_src.data_ptr(),
            e_dst.data_ptr(), att.data_ptr(), part.data_ptr(), pack.nnz,
            heads, packs.n_rows, packs.n_cols, _vec(heads, e_src, e_dst))
    edge_softmax_fwd.launches += 1
    return att


def edge_softmax_bwd(packs, att: torch.Tensor, e_src: torch.Tensor,
                     e_dst: torch.Tensor, d_att: torch.Tensor | None = None,
                     att_t: bool = True) -> tuple:
    """The backward of :func:`edge_softmax_fwd`, ``(d_e_src, d_e_dst,
    att_t)``: with ``d_att`` (the attention's cotangent, ``[H, nnz]`` in
    ``packs.fwd``'s order, as ``edge_dvals(..., a_order=True)`` writes it),
    the scores' cotangents ``[P * n_cols, H]`` (``dx = att * (d_att -
    sum_row att * d_att) * leaky_relu'``, summed per row of ``A`` into
    ``d_e_dst`` and
    per row of ``A^T`` into ``d_e_src``); with ``att_t``, ``att`` in
    ``packs.bwd``'s order (``[H, nnz]``, the per-head ``w`` of
    :func:`edge_spmm_dh`).  An output not asked for is None.  Needs
    ``packs.bwd`` and ``packs.amap``.  One walk of ``A``'s rows and one of
    ``A^T``'s, each sum in a fixed order (no atomics): two calls give the
    same bits."""
    heads = _scores("edge_softmax_bwd", packs, e_src, e_dst)
    fwd, bwd, amap = packs.fwd, packs.bwd, packs.amap
    if bwd is None or amap is None:
        raise ValueError("edge_softmax_bwd kernel: the packs carry no "
                         "transposed pack and entry map (build them with "
                         "ops.edge_packs(..., grad=True))")
    dev, nnz = e_src.device, fwd.nnz
    named = {"att": att, "amap": amap,
             **{f"bwd.{f}": getattr(bwd, f) for f in _INT_FIELDS}}
    if d_att is not None:
        named["d_att"] = d_att
    _check("edge_softmax_bwd", named, dev)
    if att.dtype != torch.float32 or att.shape != (heads, nnz) or (
            d_att is not None and (d_att.dtype != torch.float32
                                   or d_att.shape != (heads, nnz))):
        raise TypeError(f"edge_softmax_bwd kernel: att and d_att [{heads}, "
                        f"{nnz}] float32 expected, got "
                        f"{att.dtype} {tuple(att.shape)} and "
                        f"{None if d_att is None else tuple(d_att.shape)}")
    if amap.dtype != torch.int32 or amap.shape != (bwd.nnz,) or \
            bwd.nnz != nnz:
        raise TypeError("edge_softmax_bwd kernel: the entry map must be "
                        f"int32 [{nnz}]")
    n_nodes = packs.n_parts * packs.n_cols
    d_e_src = d_e_dst = out_t = dxatt = part = None
    if d_att is not None:
        # rows with no entry keep the zeros: no warp walks an empty row
        d_e_src, d_e_dst = torch.zeros((2, n_nodes, heads),
                                       dtype=torch.float32, device=dev)
    if att_t:
        out_t = torch.empty((heads, nnz), dtype=torch.float32, device=dev)
    if not nnz or (d_att is None and not att_t):
        return d_e_src, d_e_dst, out_t
    if d_att is not None:
        # dx and att entry-major (one gather an entry for the walk of
        # A^T); each long row segment's dot and d_e_dst partial per head
        dxatt = torch.empty((nnz, 2 * heads), dtype=torch.float32,
                            device=dev)
        part = torch.empty((fwd.seg.shape[0], 2, heads), dtype=torch.float32,
                           device=dev)
    fn = _entry("edge_softmax", "edge_softmax_bwd_f32", _SOFTMAX_BWD_ARGTYPES)
    ptr = (lambda t: None if t is None else t.data_ptr())
    _launch(fn, e_src.get_device(), *_rows_args(fwd), *_rows_args(bwd),
            amap.data_ptr(), e_src.data_ptr(),
            e_dst.data_ptr(), att.data_ptr(), ptr(d_att), ptr(dxatt),
            ptr(part), ptr(d_e_src), ptr(d_e_dst), ptr(out_t), nnz, heads,
            packs.n_rows, packs.n_cols, _vec(heads, e_src, e_dst))
    edge_softmax_bwd.launches += 1
    return d_e_src, d_e_dst, out_t


for _fn in (edge_spmm, edge_spmm_dh, edge_dvals, edge_softmax_fwd,
            edge_softmax_bwd):
    _fn.launches = 0
