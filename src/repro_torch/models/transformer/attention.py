"""Attention: GQA (+RoPE, qk-norm, bias, sliding window) and MLA, the JAX
package's ``models/transformer/attention.py`` in torch.

Training/prefill attention and decode go through the ``torch.library``
ops of :mod:`repro_torch.kernels.flash_attn` on every device:
``repro_torch::flash_attention`` (blocked causal or not, or banded with a
sliding window: the flash kernels ``csrc/flash_attn.cu`` on the card,
forward and a two-launch backward) and ``repro_torch::decode_attention``
(``csrc/decode_attn.cu``).  On the CPU they run the plain versions of
``kernels/ref.py``: the reference's chunked loops (a running softmax over
KV chunks, O(chunk^2) memory, so a 32k-sequence prefill needs no S x S
temporary; with a window only ``window // chunk + 1`` KV chunks per query
chunk), and a backward that recomputes each ``[q_chunk, k_chunk]`` tile
of probabilities from the row log-sum-exp.  The ops carry FLOP formulas,
so the dry run counts the same on every device.

Decode attends one query against the cache.  The softmax always runs in
f32 and the result takes the query's dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...kernels import flash_attn  # noqa: F401  (registers the ops)

__all__ = ["rope", "rope_at", "blocked_attention", "decode_attention",
           "banded_attention"]


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


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, q_chunk: int = 512,
                      k_chunk: int = 512) -> torch.Tensor:
    """Flash-style causal attention.  q [B,S,Hq,D], k/v [B,S,Hkv,D]
    (v [B,S,Hkv,Dv] with MLA's Dv != D).

    ``repro_torch::flash_attention``: the flash kernels on the card, on
    the CPU the reference's loop over ``q_chunk`` x ``k_chunk`` tiles
    (memory per step O(B * Hq * q_chunk * k_chunk)).  Its backward
    recomputes the probabilities tile by tile from the row log-sum-exp."""
    return torch.ops.repro_torch.flash_attention(q, k, v, causal, 0, q_chunk,
                                                 k_chunk)[0]


def banded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: int, *, chunk: int = 512) -> torch.Tensor:
    """Sliding-window causal attention with O(S * window) compute: on the
    card the flash kernels skip the tiles outside the band; on the CPU
    query chunk i reads only KV chunks ``i - window // chunk .. i``."""
    return torch.ops.repro_torch.flash_attention(q, k, v, True, window,
                                                 chunk, chunk)[0]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """One-token attention.  q [B,1,Hq,D], caches [B,S,Hkv,D].

    ``length`` = number of valid cache entries (the new token's position).
    The softmax runs in f32; with a window only the last ``window``
    positions score.
    """
    b, s = q.shape[0], k_cache.shape[1]
    pos = torch.arange(s, device=q.device)
    length = torch.as_tensor(length, device=q.device)
    valid = pos <= length
    if window is not None:
        valid &= pos > (length - window)
    return torch.ops.repro_torch.decode_attention(
        q, k_cache, v_cache, valid[None].expand(b, s).contiguous())

