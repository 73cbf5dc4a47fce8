"""Tier primitives of the CaPGNN stacked runtime, and the aggregation
backends over the stacked ``[P, ...]`` layout.

Every partition's state lives in one padded ``[P, ...]`` tensor; the
inter-worker exchange is gather/scatter index arithmetic over the stacked
inner matrix, compiled by :func:`repro_torch.dist.exchange.build_exchange_plan`.
These are the primitives the JAX package's ``capgnn_sim`` shares between
its runtimes; the serving precompute uses them in this slice.  The
training runtime (steps, caches, ``train_capgnn``) comes with a later one.

The reference drops out-of-range scatter indices (``mode="drop"``); torch
raises on them instead, so :func:`_scatter` writes into one spare row and
slices it off.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.gnn import EdgeListAdj, EllAdj, HybridAdj
from .exchange import ExchangeTier, GlobalTier, StackedParts

__all__ = ["RUNTIME_BACKENDS", "check_backend", "make_adj_builder"]

RUNTIME_BACKENDS = ("edges", "ell", "hybrid")


def _idx(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int64), device=device)


def _mask(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, bool), device=device)


def _tier_dict(t: ExchangeTier, device="cpu") -> dict:
    return {
        "send_row": _idx(t.send_row, device),
        "recv_src_part": _idx(t.recv_src_part, device),
        "recv_src_slot": _idx(t.recv_src_slot, device),
        "recv_halo_pos": _idx(t.recv_halo_pos, device),
        "recv_valid": _mask(t.recv_valid, device),
    }


def _glob_dict(g: GlobalTier, device="cpu") -> dict:
    return {
        "send_row": _idx(g.send_row, device),
        "src_part": _idx(g.src_part, device),
        "src_slot": _idx(g.src_slot, device),
        "read_pos": _idx(g.read_pos, device),
        "read_buf_idx": _idx(g.read_buf_idx, device),
        "read_valid": _mask(g.read_valid, device),
        "buf_valid": _mask(g.buf_valid, device),
    }


def _pack(send_row: torch.Tensor, h: torch.Tensor, halo_dtype):
    """Owners' send buffers ``[P, S, d]`` from the stacked inner matrix,
    cast to the wire dtype when one is given."""
    pidx = torch.arange(h.shape[0], device=h.device)[:, None]
    payload = h[pidx, send_row]
    return payload if halo_dtype is None else payload.to(halo_dtype)


def _pull(td: dict, h: torch.Tensor, halo_dtype=None) -> torch.Tensor:
    """Gather one tier's rows from the stacked inner matrix ``h [P,NI,d]``.

    Owners pack their send buffers, consumers address the payload by
    (src_part, src_slot).  Invalid (padding) rows are zeroed.
    ``halo_dtype`` casts the packed payload before "transport" and
    dequantises the addressed rows back to ``h.dtype``.  Returns
    ``[P, R, d]``.
    """
    payload = _pack(td["send_row"], h, halo_dtype)
    rows = payload[td["recv_src_part"], td["recv_src_slot"]].to(h.dtype)
    return torch.where(td["recv_valid"][..., None], rows, 0.0)


def _scatter(halo: torch.Tensor, pos: torch.Tensor, rows: torch.Tensor,
             valid: torch.Tensor) -> torch.Tensor:
    """Scatter tier rows into the halo buffer ``[P, NH, d]`` at ``pos``;
    invalid entries go to a spare row ``NH`` that is sliced off."""
    n_parts, nh = halo.shape[0], halo.shape[1]
    spare = halo.new_zeros((n_parts, 1) + tuple(halo.shape[2:]))
    buf = torch.cat([halo, spare], dim=1)
    pos_eff = torch.where(valid, pos, nh)
    pidx = torch.arange(n_parts, device=halo.device)[:, None]
    buf[pidx, pos_eff] = rows.to(buf.dtype)
    return buf[:, :nh]


def _build_global(gd: dict, h: torch.Tensor, halo_dtype=None) -> torch.Tensor:
    """Fill the deduplicated global buffer ``[G, d]`` from owners' rows
    (dequantised to ``h.dtype``; capacity-padding slots zeroed)."""
    payload = _pack(gd["send_row"], h, halo_dtype)
    rows = payload[gd["src_part"], gd["src_slot"]].to(h.dtype)
    return torch.where(gd["buf_valid"][:, None], rows, 0.0)


def _read_global(gd: dict, buf: torch.Tensor,
                 halo: torch.Tensor) -> torch.Tensor:
    """Serve each worker's global-tier halo positions from the buffer."""
    rows = buf[gd["read_buf_idx"]]                               # [P, RG, d]
    return _scatter(halo, gd["read_pos"], rows, gd["read_valid"])


def check_backend(sp: StackedParts, backend: str) -> None:
    """Validate a runtime backend choice against the stacked layout."""
    if backend not in RUNTIME_BACKENDS:
        raise ValueError(f"unknown aggregation backend {backend!r}; "
                         f"expected one of {RUNTIME_BACKENDS}")
    if backend != "edges" and (sp.ell is None or sp.ell.backend != backend):
        have = sp.ell.backend if sp.ell is not None else None
        raise ValueError(
            f"backend={backend!r} needs a matching stacked aggregation pack "
            f"(found {have!r}); rebuild the stacked layout with "
            f"stack_partitions(ps, task, backend={backend!r})")


def make_adj_builder(sp: StackedParts, backend: str, device="cpu"):
    """Return ``(leaves, build)``: ``leaves`` is a dict of the stacked
    ``[P, ...]`` aggregation tensors on ``device``, and ``build(leaves)``
    the :class:`~repro_torch.models.gnn.Adjacency` over all P partitions
    at once.

    Every backend aggregates over the identical edge set (the packs are
    built from the same remapped edge lists at stack time), so the backend
    changes the kernel only, not the logits.
    """
    check_backend(sp, backend)
    ni, nh = sp.n_inner_max, sp.n_halo_max

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    if backend == "edges":
        leaves = {"src": put(sp.e_src, torch.int64),
                  "dst": put(sp.e_dst, torch.int64),
                  "w": put(sp.e_w, torch.float32)}

        def build(lv):
            return EdgeListAdj(lv["src"], lv["dst"], lv["w"], ni, ni + nh)
    elif backend == "ell":
        leaves = {"cols": put(sp.ell.cols, torch.int32),
                  "vals": put(sp.ell.vals, torch.float32)}

        def build(lv):
            return EllAdj(lv["cols"], lv["vals"], ni + nh)
    else:  # hybrid
        leaves = {"cols": put(sp.ell.cols, torch.int32),
                  "vals": put(sp.ell.vals, torch.float32),
                  "tail_src": put(sp.ell.tail_src, torch.int64),
                  "tail_dst": put(sp.ell.tail_dst, torch.int64),
                  "tail_w": put(sp.ell.tail_w, torch.float32)}

        def build(lv):
            return HybridAdj(lv["cols"], lv["vals"], lv["tail_src"],
                             lv["tail_dst"], lv["tail_w"], ni + nh)
    return leaves, build
