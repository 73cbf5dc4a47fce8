"""Attention: GQA (+RoPE, qk-norm, bias, sliding window) and MLA, the JAX
package's ``models/transformer/attention.py`` in plain torch.

Training/prefill attention is **blocked** (flash-style running softmax over
KV chunks, O(chunk^2) memory), so a 32k-sequence prefill needs no S x S
temporary; with a sliding window the KV iteration is **banded** (only
``window // chunk + 1`` chunks per query chunk, O(S * W) compute).  The
reference's ``lax.map`` over query chunks and ``lax.scan`` over KV chunks
are Python loops here, and its ``jax.checkpoint`` on each KV step is
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: the
backward recomputes each ``[q_chunk, k_chunk]`` score tile instead of
keeping it.  A KV step whose every score is masked (a causal chunk past the
query chunk's last row, a band chunk before position 0) is skipped: it
would leave the running max, sum and accumulator exactly as they are.

Decode attends one query against the cache.  The softmax always runs in
f32 and the result takes the query's dtype.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = ["rope", "rope_at", "blocked_attention", "decode_attention",
           "banded_attention"]

_NEG_INF = -1e30


def _rope_angles(positions: torch.Tensor, dim: int, theta: float):
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                          device=positions.device) / dim))
    ang = positions.float()[..., None] * freqs         # [..., dim/2]
    return torch.cos(ang), torch.sin(ang)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding over *interleaved* pairs ``(x[..., ::2],
    x[..., 1::2])``.  x [..., S, H, D], positions [S]."""
    d = x.shape[-1]
    cos, sin = _rope_angles(positions, d, theta)       # [S, D/2]
    cos = cos[:, None, :]                              # [S, 1, D/2]
    sin = sin[:, None, :]
    x1, x2 = x[..., ::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


def rope_at(x: torch.Tensor, pos, theta: float) -> torch.Tensor:
    """RoPE for a single decode position. x [B, 1, H, D], pos an int or a
    0-d tensor."""
    return rope(x, torch.as_tensor(pos, device=x.device).reshape(1), theta)


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, S, nkv, D] -> [B, S, nq, D], each KV head repeated for its
    group of query heads (``jnp.repeat``: kv head j serves query heads
    ``j * rep .. (j + 1) * rep - 1``)."""
    nkv = k.shape[2]
    if nkv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // nkv, dim=2)


def _inv_sqrt(d: int) -> float:
    """``1 / sqrt(d)`` as the f32 value the reference multiplies by."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def _pad_seq(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad dim 1 of [B, S, ...] by ``pad`` rows at the end."""
    if not pad:
        return x
    return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))


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


def _step(m, l, acc, q_blk, k_blk, v_blk, mask, scale, remat: bool):
    if remat:
        return checkpoint(_softmax_step, m, l, acc, q_blk, k_blk, v_blk,
                          mask, scale, use_reentrant=False)
    return _softmax_step(m, l, acc, q_blk, k_blk, v_blk, mask, scale)


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, q_chunk: int = 512,
                      k_chunk: int = 512) -> torch.Tensor:
    """Flash-style causal attention.  q [B,S,Hq,D], k/v [B,S,Hkv,D].

    Memory per step: O(B * Hq * q_chunk * k_chunk).  Each KV step is
    checkpointed while autograd records.
    """
    b, s, hq, d = q.shape
    dv = v.shape[-1]
    k = _expand_kv(k, hq)
    v = _expand_kv(v, hq)
    qc = min(q_chunk, s)
    kc = min(k_chunk, s)
    q = _pad_seq(q, (-s) % qc)
    k = _pad_seq(k, (-s) % kc)
    v = _pad_seq(v, (-s) % kc)
    sq, sk = q.shape[1], k.shape[1]
    nq, nk = sq // qc, sk // kc
    scale = _inv_sqrt(d)
    remat = torch.is_grad_enabled()
    dev = q.device

    q_r = q.reshape(b, nq, qc, hq, d).permute(1, 0, 3, 2, 4)   # [nq,B,H,qc,D]
    k_r = k.reshape(b, nk, kc, hq, d).permute(1, 0, 3, 2, 4)
    v_r = v.reshape(b, nk, kc, hq, dv).permute(1, 0, 3, 2, 4)
    kv_valid = (torch.arange(sk, device=dev) < s).reshape(nk, kc)
    outs = []
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
            m, l, acc = _step(m, l, acc, q_r[qi], k_r[ki], v_r[ki], mask,
                              scale, remat)
        outs.append(acc / torch.clamp(l, min=1e-20)[..., None])
    out = torch.stack(outs)                                      # [nq,B,H,qc,Dv]
    out = out.permute(1, 0, 3, 2, 4).reshape(b, sq, hq, dv)
    return out[:, :s].to(q.dtype)


def banded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: int, *, chunk: int = 512) -> torch.Tensor:
    """Sliding-window causal attention with O(S * window) compute: query
    chunk i reads only KV chunks ``i - window // chunk .. i``."""
    b, s, hq, d = q.shape
    k = _expand_kv(k, hq)
    v = _expand_kv(v, hq)
    c = min(chunk, s)
    pad = (-s) % c
    q, k, v = _pad_seq(q, pad), _pad_seq(k, pad), _pad_seq(v, pad)
    sp = q.shape[1]
    n = sp // c
    n_band = min(n - 1, (window + c - 1) // c)    # trailing chunks + diagonal
    scale = _inv_sqrt(d)
    remat = torch.is_grad_enabled()
    dev = q.device
    q_r = q.reshape(b, n, c, hq, d).permute(1, 0, 3, 2, 4)    # [n,B,H,c,D]
    k_t = k.permute(0, 2, 1, 3)                               # [B,H,S,D]
    v_t = v.permute(0, 2, 1, 3)
    outs = []
    for qi in range(n):
        q_pos = qi * c + torch.arange(c, device=dev)
        m, l, acc = _run_state(b, hq, c, d, dev)
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
            m, l, acc = _step(m, l, acc, q_r[qi], k_t[:, :, start:start + c],
                              v_t[:, :, start:start + c], mask, scale, remat)
        outs.append(acc / torch.clamp(l, min=1e-20)[..., None])
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, sp, hq, d)
    return out[:, :s].to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """One-token attention.  q [B,1,Hq,D], caches [B,S,Hkv,D].

    ``length`` = number of valid cache entries (the new token's position).
    The softmax runs in f32; with a window only the last ``window``
    positions score.
    """
    b, _, hq, d = q.shape
    s = k_cache.shape[1]
    k_cache = _expand_kv(k_cache, hq)
    v_cache = _expand_kv(v_cache, hq)
    sc = torch.einsum("bohd,bshd->bhos", q.float(),
                      k_cache.float()) * _inv_sqrt(d)          # [B,H,1,S]
    pos = torch.arange(s, device=q.device)
    length = torch.as_tensor(length, device=q.device)
    mask = pos[None, None, None, :] <= length
    if window is not None:
        mask &= pos[None, None, None, :] > (length - window)
    sc = torch.where(mask, sc, _NEG_INF)
    w = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhos,bshd->bohd", w, v_cache.float())
    return out.to(q.dtype)

