"""GNN models over pluggable aggregation backends (GCN in this slice).

Layer contract (partition-parallel form): a layer maps
``h_local = concat([h_inner, h_halo])  [n_local, d_in]`` to new inner
embeddings ``[n_inner, d_out]`` via an :class:`Adjacency` whose rows are the
partition's inner vertices and whose columns are local ids.  Every
backend also takes a stack of P partitions: operands ``[P, ...]`` and one
aggregation call for all of them (the explicit batch that replaces the JAX
package's ``vmap``).  On a single worker with no partitioning, n_halo = 0
and this reduces to the textbook model.

The SAGE, GIN and GAT layers of the JAX package are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..kernels import ops
from ..nn import glorot, zeros_init

__all__ = ["Adjacency", "EdgeListAdj", "EllAdj", "HybridAdj", "GNNConfig",
           "init_gnn", "gnn_forward", "cross_entropy_loss", "bce_loss",
           "accuracy", "PORTED_MODELS"]

PORTED_MODELS = ("gcn",)
_NOT_PORTED = ("sage", "gat", "gin")


# ---------------------------------------------------------------------------
# Aggregation backends
# ---------------------------------------------------------------------------

class Adjacency:
    """Abstract aggregation operator: rows = inner vertices, cols = local."""

    n_rows: int
    n_cols: int

    def spmm(self, h: torch.Tensor) -> torch.Tensor:
        """``[..., n_cols, d] -> [..., n_rows, d]``."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class EdgeListAdj(Adjacency):
    """COO edge list + ``index_add_`` aggregation (the reference backend).
    Padding edges carry ``dst == n_rows`` and weight 0."""
    src: torch.Tensor      # [(P,) m] local col ids
    dst: torch.Tensor      # [(P,) m] inner row ids
    weight: torch.Tensor   # [(P,) m]
    n_rows_: int
    n_cols_: int

    @property
    def n_rows(self):
        return self.n_rows_

    @property
    def n_cols(self):
        return self.n_cols_

    def spmm(self, h):
        return ops.coo_spmm(self.src, self.dst, self.weight, h, self.n_rows_)


@dataclasses.dataclass(frozen=True)
class EllAdj(Adjacency):
    """Blocked-ELL adjacency backed by the ELL-SpMM kernel (differentiable:
    its ``d_h`` is the CSR kernel over ``dh_pack`` on the card)."""
    cols: torch.Tensor     # [(P,) n_rows, max_deg] int32 local col ids
    vals: torch.Tensor     # [(P,) n_rows, max_deg] weights (0 at padding)
    n_cols_: int
    row_end: torch.Tensor | None = None   # [(P,) n_rows] ops.ell_row_end
    dh_pack: ops.CsrPack | None = None    # ops.transpose_csr

    @property
    def n_rows(self):
        return self.cols.shape[-2]

    @property
    def n_cols(self):
        return self.n_cols_

    def spmm(self, h):
        return ops.ell_spmm(self.cols, self.vals, h, row_end=self.row_end,
                            dh_pack=self.dh_pack)


@dataclasses.dataclass(frozen=True)
class HybridAdj(Adjacency):
    """Hybrid blocked-ELL + COO-tail adjacency: the ELL-SpMM kernel over
    the regular part, the CSR kernel over the overflow tail (``tail_pack``)
    added into it, and one CSR kernel over the transposed whole
    (``dh_pack``) for ``d_h``.  Padded tail entries carry
    ``tail_dst == n_rows``."""
    cols: torch.Tensor      # [(P,) n_rows, max_deg] int32 local col ids
    vals: torch.Tensor      # [(P,) n_rows, max_deg] weights (0 at padding)
    tail_src: torch.Tensor  # [(P,) mt] local col ids
    tail_dst: torch.Tensor  # [(P,) mt] inner row ids (n_rows = padding)
    tail_w: torch.Tensor    # [(P,) mt] weights (0 at padding)
    n_cols_: int
    row_end: torch.Tensor | None = None   # [(P,) n_rows] ops.ell_row_end
    tail_pack: ops.CsrPack | None = None  # ops.tail_csr
    dh_pack: ops.CsrPack | None = None    # ops.transpose_csr with the tail

    @property
    def n_rows(self):
        return self.cols.shape[-2]

    @property
    def n_cols(self):
        return self.n_cols_

    def spmm(self, h):
        return ops.hybrid_spmm(self.cols, self.vals, self.tail_src,
                               self.tail_dst, self.tail_w, h,
                               row_end=self.row_end,
                               tail_pack=self.tail_pack,
                               dh_pack=self.dh_pack)


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GNNConfig:
    model: str = "gcn"            # gcn (sage | gat | gin: not ported yet)
    in_dim: int = 64
    hidden_dim: int = 256         # paper: 256
    out_dim: int = 16
    num_layers: int = 3           # paper: 3
    num_heads: int = 4            # GAT
    residual: bool = False

    @property
    def layer_dims(self) -> list[tuple[int, int]]:
        dims = [self.in_dim] + [self.hidden_dim] * (self.num_layers - 1) + [self.out_dim]
        return list(zip(dims[:-1], dims[1:]))

    @property
    def feat_dims(self) -> list[int]:
        """Per-tier cached row widths: input features + each layer output."""
        return [self.in_dim] + [self.hidden_dim] * (self.num_layers - 1) + [self.out_dim]


def _check_model(model: str) -> None:
    if model in _NOT_PORTED:
        raise NotImplementedError(
            f"model {model!r} is not ported to repro_torch yet: the SAGE, "
            "GIN and GAT layers come with a later slice; use model='gcn'")
    if model not in PORTED_MODELS:
        raise ValueError(f"unknown model {model!r}")


def init_gnn(cfg: GNNConfig, generator: torch.Generator,
             device="cuda") -> list[dict[str, torch.Tensor]]:
    """``[{"w": [din, dout], "b": [dout]}, ...]`` per layer (the JAX
    package's layout), Glorot weights and zero biases, on ``device`` (the
    card unless the caller asks for the CPU)."""
    _check_model(cfg.model)
    return [{"w": glorot((din, dout), generator, device),
             "b": zeros_init((dout,), device)}
            for din, dout in cfg.layer_dims]


def _layer_apply(cfg: GNNConfig, p: dict, adj: Adjacency,
                 h_local: torch.Tensor, n_inner: int,
                 is_last: bool) -> torch.Tensor:
    _check_model(cfg.model)
    z = adj.spmm(h_local) @ p["w"] + p["b"]
    if not is_last:
        z = torch.relu(z)
    return z


def gnn_forward(cfg: GNNConfig, params: list[dict], adj: Adjacency,
                h_inner: torch.Tensor,
                halo_embeds: Sequence[torch.Tensor] | None) -> torch.Tensor:
    """Partition-local forward (or a ``[P, ...]`` stack of them).

    ``halo_embeds[l]`` are the halo embeddings consumed by layer ``l``
    (layer 0: halo input features; layer l>0: remote layer-(l) inputs).
    ``None`` means no halo (single-worker full graph).
    Returns inner-vertex logits.
    """
    n_inner = h_inner.shape[-2]
    h = h_inner
    for li, p in enumerate(params):
        if halo_embeds is not None:
            h_local = torch.cat([h, halo_embeds[li]], dim=-2)
        else:
            h_local = h
        h = _layer_apply(cfg, p, adj, h_local, n_inner,
                         is_last=(li == len(params) - 1))
    return h


# ---------------------------------------------------------------------------
# Losses / metrics
# ---------------------------------------------------------------------------

def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean softmax cross entropy over the rows where ``mask`` is set
    (the sum over masked rows divided by ``max(mask.sum(), 1)``)."""
    logp = torch.log_softmax(logits, -1)
    nll = -torch.gather(logp, -1, labels[:, None].long())[:, 0]
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def bce_loss(logits: torch.Tensor, targets: torch.Tensor,
             mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean binary cross entropy with logits, in the JAX package's
    numerically stable form."""
    per = (torch.clamp(logits, min=0) - logits * targets
           + torch.log1p(torch.exp(-torch.abs(logits))))
    per = per.mean(-1)
    if mask is not None:
        return torch.sum(per * mask) / torch.clamp(mask.sum(), min=1.0)
    return per.mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor | None = None) -> torch.Tensor:
    """Share of rows (where ``mask`` is set) whose argmax is the label."""
    correct = (torch.argmax(logits, -1) == labels).float()
    if mask is not None:
        return torch.sum(correct * mask) / torch.clamp(mask.sum(), min=1.0)
    return correct.mean()
