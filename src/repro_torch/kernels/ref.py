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

Attention (:func:`flash_attention_ref`, :func:`flash_attention_bwd_ref`,
:func:`decode_attention_ref`): scores in f32, a masked score set to
``-1e30`` (not skipped), the result in the query's dtype, as the JAX
package computes them.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["ell_spmm_ref", "ell_spmm_chunked_ref", "ell_spmm_bwd_ref",
           "csr_spmm_ref", "edge_dvals_ref", "edge_softmax_ref",
           "edge_softmax_bwd_ref", "gather_rows_ref", "cache_combine_ref",
           "masked_mean_ref", "flash_attention_ref", "flash_attention_bwd_ref",
           "decode_attention_ref", "inv_sqrt", "expand_kv"]

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


def _pack_rows(pack, device) -> torch.Tensor:
    """Each entry's row of a CSR pack, int64 ``[nnz]``."""
    return torch.repeat_interleave(
        torch.arange(pack.n_rows, device=device),
        (pack.rowptr[1:] - pack.rowptr[:-1]).long())


def edge_dvals_ref(pack, g: torch.Tensor, h: torch.Tensor,
                   n_edges: int, a_order: bool = False) -> torch.Tensor:
    """``d_vals [n_edges]`` f32 for an edge list's forward pack: ``<g[r],
    h[c]>`` at ``pack.perm[k]`` for each entry ``k = (r, c)``, 0 at the
    edges the pack does not hold (padding); per head, ``[n_edges, H]``,
    for ``g [n_rows, H, dh]`` and ``h [n_cols, H, dh]``; with ``a_order``,
    in the pack's order, ``[nnz]`` or ``[H, nnz]``: what
    ``csrc/edge_dvals.cu`` computes.  Over chunks of entries, so ``[nnz,
    d]`` is never built whole."""
    rows = _pack_rows(pack, g.device)
    col = pack.col.long()
    perm = (torch.arange(pack.nnz, device=g.device) if a_order
            else pack.perm.long())
    g32, h32 = g.float(), h.float()
    out = torch.zeros((pack.nnz if a_order else n_edges,)
                      + tuple(g.shape[1:-1]), dtype=torch.float32,
                      device=g.device)
    for lo in range(0, pack.nnz, _CSR_CHUNK):
        hi = lo + _CSR_CHUNK
        out[perm[lo:hi]] = (g32[rows[lo:hi]] * h32[col[lo:hi]]).sum(-1)
    return out.t().contiguous() if a_order else out


def _edge_logits(pack, e_src: torch.Tensor, e_dst: torch.Tensor,
                 n_rows: int, n_cols: int):
    """``(rows, x)``: each entry's row of an edge list's forward pack and
    ``x = e_src[col] + e_dst[node(row)]`` ``[nnz, H]``, ``node(r) = (r //
    n_rows) * n_cols + r % n_rows`` (the destination's local id)."""
    rows = _pack_rows(pack, e_src.device)
    node = rows // n_rows * n_cols + rows % n_rows
    return rows, e_src[pack.col.long()] + e_dst[node]


def edge_softmax_ref(pack, e_src: torch.Tensor, e_dst: torch.Tensor,
                     n_rows: int, n_cols: int) -> torch.Tensor:
    """GAT's attention over an edge list's forward pack, ``[H, nnz]`` in the
    pack's order: ``softmax(leaky_relu(e_src[col] + e_dst[node(row)],
    0.2))`` over each row's entries (the row's max taken outside
    autograd, its sum clamped at 1e-9), for ``e_src`` / ``e_dst`` ``[P *
    n_cols, H]`` and ``n_rows`` / ``n_cols`` a partition's: what
    ``edge_softmax_fwd`` in ``csrc/edge_softmax.cu`` computes.
    Differentiable in the scores."""
    rows, x = _edge_logits(pack, e_src, e_dst, n_rows, n_cols)
    logits = torch.nn.functional.leaky_relu(x, 0.2)
    heads = logits.shape[1]
    with torch.no_grad():
        seg_max = logits.new_full((pack.n_rows, heads), -torch.inf)
        seg_max.scatter_reduce_(0, rows[:, None].expand(-1, heads), logits,
                                "amax")
    ex = torch.exp(logits - seg_max[rows])
    denom = ex.new_zeros((pack.n_rows, heads)).index_add(0, rows, ex)
    return (ex / torch.clamp(denom[rows], min=1e-9)).t().contiguous()


def edge_softmax_bwd_ref(fwd, bwd, amap: torch.Tensor, att: torch.Tensor,
                         d_att: torch.Tensor | None, e_src: torch.Tensor,
                         e_dst: torch.Tensor, n_rows: int, n_cols: int,
                         att_t: bool = True):
    """The backward of :func:`edge_softmax_ref`, ``(d_e_src, d_e_dst,
    att_t)``, as ``csrc/edge_softmax.cu`` computes it: for ``att`` and
    ``d_att`` ``[H, nnz]`` in the forward pack's order, ``dx = att *
    (d_att - sum_row att * d_att) * (x > 0 ? 1 : 0.2)``, summed per row
    of ``fwd`` into ``d_e_dst`` (less its part at slope 1, which sums to 0
    over a row whose att sums to 1: the sum keeps no rounding noise of
    that cancellation) and, through the entry map ``amap`` (each ``bwd``
    entry's ``fwd`` entry), per row of ``bwd`` into ``d_e_src`` (``[P *
    n_cols, H]``); ``att`` in ``bwd``'s order (``att[:, amap]``)
    with ``att_t``.  Without ``d_att`` the scores' cotangents are None;
    without ``att_t`` so is ``att_t``."""
    out_t = att[:, amap.long()] if att_t else None
    if d_att is None:
        return None, None, out_t
    rows, x = _edge_logits(fwd, e_src, e_dst, n_rows, n_cols)
    a, da = att.t(), d_att.t()
    dot = a.new_zeros((fwd.n_rows, a.shape[1])).index_add(0, rows, a * da)
    u = a * (da - dot[rows])
    dx = u * torch.where(x > 0, 1.0, 0.2)
    node = rows // n_rows * n_cols + rows % n_rows
    d_e_dst = dx.new_zeros(e_dst.shape).index_add(
        0, node, u * torch.where(x > 0, 0.0, 0.2 - 1.0))
    d_e_src = dx.new_zeros(e_src.shape).index_add(
        0, _pack_rows(bwd, dx.device), dx[amap.long()])
    return d_e_src, d_e_dst, out_t


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


# ---------------------------------------------------------------------------
# attention (csrc/flash_attn.cu, csrc/decode_attn.cu)
# ---------------------------------------------------------------------------

_NEG_INF = -1e30


def inv_sqrt(d: int) -> float:
    """``1 / sqrt(d)`` as the f32 value the reference multiplies by."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, S, nkv, D] -> [B, S, nq, D], each KV head repeated for its
    group of query heads (``jnp.repeat``: kv head j serves query heads
    ``j * rep .. (j + 1) * rep - 1``)."""
    nkv = k.shape[2]
    if nkv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // nkv, dim=2)


def _pad_seq(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad dim 1 of [B, S, ...] by ``pad`` rows at the end."""
    if not pad:
        return x
    return torch.nn.functional.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))


def _softmax_step(m, l, acc, q_blk, k_blk, v_blk, mask, scale: float):
    """One KV step of the running softmax: ``(m, l, acc)`` after the
    ``[qc, kc]`` score tile of ``q_blk`` against ``k_blk`` (f32)."""
    sc = torch.einsum("bhqd,bhkd->bhqk", q_blk.float(), k_blk.float()) * scale
    sc = torch.where(mask, sc, _NEG_INF)
    m_new = torch.maximum(m, sc.amax(-1))
    p = torch.exp(sc - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(-1)
    acc_new = acc * corr[..., None] + torch.einsum(
        "bhqk,bhkd->bhqd", p, v_blk.float())
    return m_new, l_new, acc_new


def _run_state(b: int, h: int, qc: int, dv: int, device):
    return (torch.full((b, h, qc), _NEG_INF, dtype=torch.float32,
                       device=device),
            torch.zeros((b, h, qc), dtype=torch.float32, device=device),
            torch.zeros((b, h, qc, dv), dtype=torch.float32, device=device))


def _owned(x: torch.Tensor) -> torch.Tensor:
    """``x`` owning its storage with the row-major strides of its shape, as
    the kernels' outputs and the fake implementations' are: a view, or a
    contiguous tensor with other strides on a size-1 dimension, makes
    autograd and DTensor copy where they would not on the card or under
    ``FakeTensorMode`` (the dry run would count other bytes)."""
    strides, step = [], 1
    for n in reversed(x.shape):
        strides.append(step)
        step *= n
    if x._base is None and x.stride() == tuple(reversed(strides)):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _finish(outs, lses, b: int, s: int, sq: int, hq: int, dv: int, dtype):
    """The query chunks' results [n, B, H, c, Dv] and log-sum-exps
    [n, B, H, c] as ``(o [B, S, H, Dv], lse [B, H, S])``."""
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, sq, hq, dv)
    lse = torch.stack(lses).permute(1, 2, 0, 3).reshape(b, hq, sq)
    return _owned(out[:, :s].to(dtype)), _owned(lse[..., :s])


def _blocked(q, k, v, causal: bool, q_chunk: int, k_chunk: int):
    """The JAX package's ``blocked_attention`` loop (a running softmax
    over KV chunks, a KV step whose every score is masked skipped: it
    would leave the state as it is)."""
    b, s, hq, d = q.shape
    dv = v.shape[-1]
    k = expand_kv(k, hq)
    v = expand_kv(v, hq)
    qc = min(q_chunk, s)
    kc = min(k_chunk, s)
    q = _pad_seq(q, (-s) % qc)
    k = _pad_seq(k, (-s) % kc)
    v = _pad_seq(v, (-s) % kc)
    sq, sk = q.shape[1], k.shape[1]
    nq, nk = sq // qc, sk // kc
    scale = inv_sqrt(d)
    dev = q.device

    q_r = q.reshape(b, nq, qc, hq, d).permute(1, 0, 3, 2, 4)   # [nq,B,H,qc,D]
    k_r = k.reshape(b, nk, kc, hq, d).permute(1, 0, 3, 2, 4)
    v_r = v.reshape(b, nk, kc, hq, dv).permute(1, 0, 3, 2, 4)
    kv_valid = (torch.arange(sk, device=dev) < s).reshape(nk, kc)
    outs, lses = [], []
    for qi in range(nq):
        q_pos = qi * qc + torch.arange(qc, device=dev)
        m, l, acc = _run_state(b, hq, qc, dv, dev)
        for ki in range(nk):
            if causal and ki * kc > qi * qc + qc - 1:
                break                       # every score of the tile masked
            k_pos = ki * kc + torch.arange(kc, device=dev)
            mask = kv_valid[ki][None, None, None, :]
            if causal:
                mask = mask & (k_pos[None, None, None, :]
                               <= q_pos[None, None, :, None])
            m, l, acc = _softmax_step(m, l, acc, q_r[qi], k_r[ki], v_r[ki],
                                      mask, scale)
        outs.append(acc / torch.clamp(l, min=1e-20)[..., None])
        lses.append(m + torch.log(l))
    return _finish(outs, lses, b, s, sq, hq, dv, q.dtype)


def _banded(q, k, v, window: int, chunk: int):
    """The JAX package's ``banded_attention`` loop: query chunk i reads
    only KV chunks ``i - window // chunk .. i`` (one before position 0
    skipped: every score of it is masked)."""
    b, s, hq, d = q.shape
    dv = v.shape[-1]
    k = expand_kv(k, hq)
    v = expand_kv(v, hq)
    c = min(chunk, s)
    pad = (-s) % c
    q, k, v = _pad_seq(q, pad), _pad_seq(k, pad), _pad_seq(v, pad)
    sp = q.shape[1]
    n = sp // c
    n_band = min(n - 1, (window + c - 1) // c)    # trailing chunks + diagonal
    scale = inv_sqrt(d)
    dev = q.device
    q_r = q.reshape(b, n, c, hq, d).permute(1, 0, 3, 2, 4)    # [n,B,H,c,D]
    k_t = k.permute(0, 2, 1, 3)                               # [B,H,S,D]
    v_t = v.permute(0, 2, 1, 3)
    outs, lses = [], []
    for qi in range(n):
        q_pos = qi * c + torch.arange(c, device=dev)
        m, l, acc = _run_state(b, hq, c, dv, dev)
        for off in range(n_band + 1):
            ki = qi - n_band + off                 # chunk index
            if ki < 0:
                continue                           # every score masked
            start = ki * c
            k_pos = start + torch.arange(c, device=dev)
            mask = (k_pos[None, None, None, :] <= q_pos[None, None, :, None])
            mask &= (q_pos[None, None, :, None] - k_pos[None, None, None, :]
                     < window)
            mask &= (k_pos[None, None, None, :] < s)
            m, l, acc = _softmax_step(m, l, acc, q_r[qi],
                                      k_t[:, :, start:start + c],
                                      v_t[:, :, start:start + c], mask, scale)
        outs.append(acc / torch.clamp(l, min=1e-20)[..., None])
        lses.append(m + torch.log(l))
    return _finish(outs, lses, b, s, sp, hq, dv, q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        q_chunk: int = 512, k_chunk: int = 512
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Attention of q [B, S, Hq, Dqk] over k [B, S, Hkv, Dqk], v [B, S,
    Hkv, Dv] (GQA: ``Hq % Hkv == 0``): ``(o [B, S, Hq, Dv] in q's dtype,
    lse [B, Hq, S] f32)``, ``lse`` the log-sum-exp of each row's visible
    scores.  ``window`` 0: the reference's ``blocked_attention`` loop over
    ``q_chunk`` x ``k_chunk`` tiles (``causal`` or not); else (causal) its
    ``banded_attention`` loop over ``q_chunk``-row chunks, key j visible
    to query i when ``0 <= i - j < window``."""
    if window:
        if not causal:
            raise ValueError("a window needs causal attention")
        return _banded(q, k, v, window, q_chunk)
    return _blocked(q, k, v, causal, q_chunk, k_chunk)


def flash_attention_bwd_ref(do: torch.Tensor, q: torch.Tensor,
                            k: torch.Tensor, v: torch.Tensor,
                            o: torch.Tensor, lse: torch.Tensor,
                            causal: bool = True, window: int = 0,
                            q_chunk: int = 512, k_chunk: int = 512
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`flash_attention_ref` from the output's
    cotangent ``do``, by the CUDA kernels' algorithm over the same tiles:
    ``P = exp(s - lse)`` recomputed tile by tile (0 where masked),
    ``Delta = rowsum(do * o)``, ``dS = P * (do v^T - Delta)``, ``dq =
    scale dS k``, ``dk = scale dS^T q``, ``dv = P^T do``, then dk and dv
    summed over each KV head's group of query heads.  f32 sums, each
    result in its operand's dtype."""
    b, s, hq, d = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    rep = hq // max(hkv, 1)       # a rank's empty shard: no heads at all
    scale = inv_sqrt(d)
    qc = min(q_chunk, s)
    kc = qc if window else min(k_chunk, s)
    qf = q.float().transpose(1, 2)                               # [B,H,S,D]
    kf = expand_kv(k, hq).float().transpose(1, 2)
    vf = expand_kv(v, hq).float().transpose(1, 2)
    dof = do.float().transpose(1, 2)
    delta = (dof * o.float().transpose(1, 2)).sum(-1)            # [B,H,S]
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dvv = torch.zeros_like(vf)
    pos = torch.arange(s, device=q.device)
    for q0 in range(0, s, qc):
        q1 = min(s, q0 + qc)
        lo = max(0, q0 - window + 1) if window else 0
        hi = q1 if causal else s
        for k0 in range(lo - lo % kc, hi, kc):
            k1 = min(s, k0 + kc)
            qp, kp = pos[q0:q1, None], pos[None, k0:k1]
            mask = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask &= kp <= qp
            if window:
                mask &= qp - kp < window
            sc = torch.einsum("bhqd,bhkd->bhqk", qf[:, :, q0:q1],
                              kf[:, :, k0:k1]) * scale
            p = torch.where(mask, torch.exp(sc - lse[:, :, q0:q1, None]), 0.0)
            dp = torch.einsum("bhqd,bhkd->bhqk", dof[:, :, q0:q1],
                              vf[:, :, k0:k1])
            ds = p * (dp - delta[:, :, q0:q1, None])
            dq[:, :, q0:q1] += torch.einsum("bhqk,bhkd->bhqd", ds,
                                            kf[:, :, k0:k1])
            dk[:, :, k0:k1] += torch.einsum("bhqk,bhqd->bhkd", ds,
                                            qf[:, :, q0:q1])
            dvv[:, :, k0:k1] += torch.einsum("bhqk,bhqd->bhkd", p,
                                             dof[:, :, q0:q1])
    dk = dk.reshape(b, hkv, rep, s, d).sum(2)
    dvv = dvv.reshape(b, hkv, rep, s, dv).sum(2)
    return (_owned((dq * scale).transpose(1, 2).to(q.dtype)),
            _owned((dk * scale).transpose(1, 2).to(k.dtype)),
            _owned(dvv.transpose(1, 2).to(v.dtype)))


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, valid: torch.Tensor
                         ) -> torch.Tensor:
    """One-token attention of q [B, 1, Hq, D] over caches [B, W, Hkv, D]
    with a per-slot mask ``valid`` [B, W]: the JAX package's
    ``_decode_attn_ring`` (a masked score set to ``-1e30``, so a row with
    no valid slot gets the mean of its V rows).  The softmax runs in f32;
    the result has q's dtype."""
    hq, hd = q.shape[2], q.shape[3]
    ck = expand_kv(k_cache, hq)
    cv = expand_kv(v_cache, hq)
    sc = torch.einsum("bohd,bshd->bhos", q.float(), ck.float()) * inv_sqrt(hd)
    sc = torch.where(valid[:, None, None, :], sc, _NEG_INF)
    w = torch.softmax(sc, dim=-1)
    o = torch.einsum("bhos,bshd->bohd", w, cv.float())
    return _owned(o.to(q.dtype))
