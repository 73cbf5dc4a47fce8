"""Plain PyTorch versions of the port's kernels.

They compute what the CUDA kernels compute, op by op, on any device.  The
kernel wrappers in :mod:`.ops` take them for CPU tensors; the tests and
``chip_smoke.py`` hold the kernels against them.
"""
from __future__ import annotations

import torch

__all__ = ["ell_spmm_ref", "gather_rows_ref"]


def ell_spmm_ref(cols: torch.Tensor, vals: torch.Tensor,
                 h: torch.Tensor) -> torch.Tensor:
    """``out[..., i, :] = sum_k vals[..., i, k] * h[..., cols[..., i, k], :]``
    with f32 sums, for 2-D operands or a ``[P, ...]`` stack.

    Walks the slots one at a time and never builds ``h[cols]`` whole: at
    the flickr serving slice's shapes that tensor would take
    4 x 41,522 x 144 x 500 x 4 B, about 48 GB.  The result has ``h``'s
    dtype.
    """
    batched = h.dim() == 3
    if not batched:
        cols, vals, h = cols[None], vals[None], h[None]
    n_parts, n_rows, k = cols.shape
    pidx = torch.arange(n_parts, device=h.device)[:, None]
    cols = cols.long()
    h32 = h.float()
    out = torch.zeros((n_parts, n_rows, h.shape[-1]), dtype=torch.float32,
                      device=h.device)
    for j in range(k):
        out += vals[..., j, None].float() * h32[pidx, cols[..., j]]
    out = out.to(h.dtype)
    return out if batched else out[0]


def gather_rows_ref(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i] = src[idx[i]]``."""
    return src[idx.long()]
