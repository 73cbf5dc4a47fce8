"""GNN models (GCN, GraphSAGE, GAT, GIN) over pluggable aggregation
backends.

Layer contract (partition-parallel form): a layer maps
``h_local = concat([h_inner, h_halo])  [n_local, d_in]`` to new inner
embeddings ``[n_inner, d_out]`` via an :class:`Adjacency` whose rows are the
partition's inner vertices and whose columns are local ids.  Every
backend also takes a stack of P partitions: operands ``[P, ...]`` and one
aggregation call for all of them (the explicit batch that replaces the JAX
package's ``vmap``).  On a single worker with no partitioning, n_halo = 0
and this reduces to the textbook model.

GAT's edge softmax gives padding edges (``dst == n_rows``, the stacked
layout's) zero attention and a finite gradient (:func:`_edge_softmax`);
the JAX package's gives them NaN gradients in a partition with fewer
inner rows than the stack's width.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..kernels import ops
from ..nn import glorot, zeros_init

__all__ = ["Adjacency", "DenseAdj", "EdgeListAdj", "EllAdj", "HybridAdj",
           "BACKENDS", "GNNConfig", "init_gnn", "gnn_forward",
           "make_local_adj", "cross_entropy_loss", "bce_loss", "accuracy",
           "PORTED_MODELS"]

BACKENDS = ("edges", "dense", "ell", "hybrid")
PORTED_MODELS = ("gcn", "sage", "gat", "gin")


# ---------------------------------------------------------------------------
# Aggregation backends
# ---------------------------------------------------------------------------

class Adjacency:
    """Abstract aggregation operator: rows = inner vertices, cols = local.

    Every backend provides ``spmm`` and ``degree``; ``spmm_at`` (per-edge
    values, the GAT edge-softmax path) is a capability: backends that
    cannot express it raise a :class:`NotImplementedError` naming
    themselves and the ``backend="edges"`` fallback.
    """

    n_rows: int
    n_cols: int

    def spmm(self, h: torch.Tensor) -> torch.Tensor:
        """``[..., n_cols, d] -> [..., n_rows, d]``."""
        raise NotImplementedError

    def _rows_tensor(self) -> torch.Tensor:
        """A ``[..., n_rows, k]`` tensor of the operator (its stack's
        leading dims and device)."""
        raise NotImplementedError

    def degree(self) -> torch.Tensor:
        """Weighted in-degree per inner row, ``[..., n_rows]``.

        Default: ``spmm`` against a ones column ``[..., n_cols, 1]``,
        exact since padding entries carry zero weight.  It is computed at
        every call, as the reference does: with ``ell`` or ``hybrid`` on
        the card one ELL-SpMM launch at d = 1 and, for ``hybrid``, one CSR
        launch over the tail.
        """
        like = self._rows_tensor()
        ones = torch.ones(tuple(like.shape[:-2]) + (self.n_cols, 1),
                          device=like.device)
        return self.spmm(ones)[..., 0]

    def spmm_at(self, e_vals: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """SpMM with externally supplied per-edge values (GAT attention)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support per-edge-value "
            "aggregation (spmm_at); GAT's edge softmax needs flat edge ids "
            "- build the adjacency with backend='edges'.")


@dataclasses.dataclass(frozen=True)
class DenseAdj(Adjacency):
    """Dense normalized adjacency (tests / tiny graphs): ``mat @ h``, a
    plain product, as the reference's."""
    mat: torch.Tensor   # [(P,) n_rows, n_cols]

    @property
    def n_rows(self):
        return self.mat.shape[-2]

    @property
    def n_cols(self):
        return self.mat.shape[-1]

    def _rows_tensor(self):
        return self.mat

    def spmm(self, h):
        return self.mat @ h


@dataclasses.dataclass(frozen=True)
class EdgeListAdj(Adjacency):
    """COO edge list aggregation (the reference backend).  Padding edges
    carry ``dst == n_rows`` and weight 0.

    On CPU tensors the plain version, :func:`~repro_torch.kernels.ops.
    coo_spmm` (``index_add_``); on the card the hand-written CSR kernels
    over ``packs`` (:func:`~repro_torch.kernels.ops.edge_packs` of the same
    edges, built once with them; :func:`~repro_torch.kernels.ops.
    edge_spmm`), which an edge list on the card must carry: without them
    it raises."""
    src: torch.Tensor      # [(P,) m] local col ids
    dst: torch.Tensor      # [(P,) m] inner row ids
    weight: torch.Tensor   # [(P,) m]
    n_rows_: int
    n_cols_: int
    packs: ops.EdgePacks | None = None

    @property
    def n_rows(self):
        return self.n_rows_

    @property
    def n_cols(self):
        return self.n_cols_

    def spmm(self, h):
        if h.device.type == "cpu":
            return ops.coo_spmm(self.src, self.dst, self.weight, h,
                                self.n_rows_)
        return ops.edge_spmm(h, self.packs)

    def spmm_at(self, e_vals, h):
        """The aggregation with ``e_vals [(P,) m]`` as the edge weights;
        differentiable in them (on the card, ``d_e_vals`` is the
        ``edge_dvals`` kernel).  GAT's heads in one call: ``e_vals [(P,)
        m, H]`` with ``h [(P,) n_cols, H, dh]`` gives ``[(P,) n_rows, H,
        dh]``, head ``z`` weighted by ``e_vals[..., z]`` (on the card one
        launch of each kernel for all the heads; on the CPU the
        reference's loop over the heads)."""
        if h.device.type != "cpu":
            return ops.edge_spmm(h, self.packs, e_vals)
        if not ops.value_heads(e_vals, self.src.shape[-1]):
            return ops.coo_spmm(self.src, self.dst, e_vals, h, self.n_rows_)
        return torch.stack([ops.coo_spmm(self.src, self.dst, e_vals[..., z],
                                         h[..., z, :], self.n_rows_)
                            for z in range(e_vals.shape[-1])], dim=-2)

    def degree(self):
        """The weights summed per ``dst`` (weighted in-degree, the
        ``spmm(ones)`` of the other backends); padding edges land in the
        spare row."""
        return ops.segment_sum(self.weight, self.dst, self.n_rows_)


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

    def _rows_tensor(self):
        return self.cols

    def spmm(self, h):
        return ops.ell_spmm(self.cols, self.vals, h, row_end=self.row_end,
                            dh_pack=self.dh_pack)

    def spmm_at(self, e_vals, h):
        """SpMM with ELL-shaped per-edge values ``[(P,) n_rows, max_deg]``.

        Padding slots (``vals == 0``) are masked out, so callers may pass
        unmasked scores in the same ELL layout.  The values are not the
        constants ``row_end`` and ``dh_pack`` were built from, so neither
        is passed: the backward's ``d_h`` takes a pack built for the call
        and ``d_vals`` is the ELL ``d_vals`` kernel on the card.
        """
        v = torch.where(self.vals != 0, e_vals, 0.0)
        return ops.ell_spmm(self.cols, v, h)


@dataclasses.dataclass(frozen=True)
class HybridAdj(Adjacency):
    """Hybrid blocked-ELL + COO-tail adjacency: the ELL-SpMM kernel over
    the regular part, the CSR kernel over the overflow tail (``tail_pack``)
    added into it, and one CSR kernel over the transposed whole
    (``dh_pack``) for ``d_h``.  Padded tail entries carry
    ``tail_dst == n_rows``.  No ``spmm_at``, as the reference."""
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

    def _rows_tensor(self):
        return self.cols

    def spmm(self, h):
        return ops.hybrid_spmm(self.cols, self.vals, self.tail_src,
                               self.tail_dst, self.tail_w, h,
                               row_end=self.row_end,
                               tail_pack=self.tail_pack,
                               dh_pack=self.dh_pack)


def make_local_adj(local_graph, n_inner: int, backend: str = "edges",
                   device="cuda") -> Adjacency:
    """An :class:`Adjacency` on ``device`` (the card unless the caller asks
    for the CPU) for a partition-local graph (rows = its first
    ``n_inner`` vertices).  The ``ell`` and ``hybrid`` packs come with
    ``row_end``, the tail's CSR and the transposed CSR for ``d_h``, and
    the edge list with its CSR packs, built here once, as
    ``dist.capgnn_sim.make_adj_builder`` builds them."""
    src, dst = local_graph.edges()
    keep = dst < n_inner
    src, dst = src[keep], dst[keep]
    w = (local_graph.edge_weight[keep] if local_graph.edge_weight is not None
         else np.ones(src.shape[0], np.float32))
    n_cols = local_graph.num_nodes
    device = torch.device(device)

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    if backend == "dense":
        mat = np.zeros((n_inner, n_cols), np.float32)
        mat[dst, src] = w
        return DenseAdj(put(mat, torch.float32))
    if backend == "edges":
        src, dst, w = (put(src, torch.int64), put(dst, torch.int64),
                       put(w, torch.float32))
        return EdgeListAdj(src, dst, w, n_inner, n_cols,
                           ops.edge_packs(src, dst, w, n_inner, n_cols))
    if backend == "ell":
        cols, vals = ops.ell_pack(src, dst, w, n_inner)
        return EllAdj(put(cols, torch.int32), put(vals, torch.float32),
                      n_cols, put(ops.ell_row_end(vals), torch.int32),
                      ops.transpose_csr(cols, vals, n_cols, device=device))
    if backend == "hybrid":
        cols, vals, ts, td, tw = ops.ell_pack_hybrid(src, dst, w, n_inner)
        return HybridAdj(
            put(cols, torch.int32), put(vals, torch.float32),
            put(ts, torch.int64), put(td, torch.int64),
            put(tw, torch.float32), n_cols,
            put(ops.ell_row_end(vals), torch.int32),
            ops.tail_csr(ts, td, tw, n_inner, n_cols, device=device),
            ops.transpose_csr(cols, vals, n_cols, ts, td, tw, device=device))
    raise ValueError(f"unknown aggregation backend {backend!r}; "
                     f"expected one of {BACKENDS}")


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GNNConfig:
    model: str = "gcn"            # gcn | sage | gat | gin
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
    if model not in PORTED_MODELS:
        raise ValueError(f"unknown model {model!r}; expected one of "
                         f"{PORTED_MODELS}")


def init_gnn(cfg: GNNConfig, generator: torch.Generator,
             device="cuda") -> list[dict[str, torch.Tensor]]:
    """Per layer the JAX package's parameter names and shapes, Glorot
    weights and zero biases (GIN's ``eps`` a 0-d zero), on ``device``
    (the card unless the caller asks for the CPU):

    - ``gcn``: ``w [din, dout]``, ``b [dout]``;
    - ``sage``: ``w_self``, ``w_neigh [din, dout]``, ``b``;
    - ``gat``: ``w [din, H * dh]``, ``a_src``, ``a_dst [H, dh]``,
      ``proj [H * dh, dout]`` with ``dh = max(1, dout // H)``;
    - ``gin``: ``w1 [din, dout]``, ``b1``, ``w2 [dout, dout]``, ``b2``,
      ``eps []``.
    """
    _check_model(cfg.model)
    params = []
    for din, dout in cfg.layer_dims:
        def g(shape):
            return glorot(shape, generator, device)
        if cfg.model == "gcn":
            p = {"w": g((din, dout)), "b": zeros_init((dout,), device)}
        elif cfg.model == "sage":
            p = {"w_self": g((din, dout)), "w_neigh": g((din, dout)),
                 "b": zeros_init((dout,), device)}
        elif cfg.model == "gat":
            h = cfg.num_heads
            dh = max(1, dout // h)
            p = {"w": g((din, h * dh)), "a_src": g((h, dh)),
                 "a_dst": g((h, dh)), "proj": g((h * dh, dout))}
        else:
            p = {"w1": g((din, dout)), "b1": zeros_init((dout,), device),
                 "w2": g((dout, dout)), "b2": zeros_init((dout,), device),
                 "eps": zeros_init((), device)}
        params.append(p)
    return params


def _edge_rows(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``x[..., ids, :]`` for ``x [(P,) n, k]`` and ``ids [(P,) m]`` as one
    ``index_select`` over the flattened ``x`` (its backward an
    ``index_add_``)."""
    batched = x.dim() == 3
    if not batched:
        x, ids = x[None], ids[None]
    n_parts, n, k = x.shape
    pidx = torch.arange(n_parts, device=x.device)[:, None]
    out = x.reshape(-1, k).index_select(0, (pidx * n + ids).reshape(-1))
    out = out.view(n_parts, -1, k)
    return out if batched else out[0]


def _edge_softmax(logits: torch.Tensor, dst: torch.Tensor,
                  n_rows: int) -> torch.Tensor:
    """The softmax of ``logits [(P,) m, H]`` over each inner row's
    incoming edges, 0 at the padding edges (``dst == n_rows``).

    The padding edges make one more segment, the spare row of
    :func:`~repro_torch.kernels.ops.segment_sum`: its max and sum are
    their own, so every exponent is at most 0 and every quotient finite
    before the padding attention is set to 0, and no inf or NaN reaches a
    product that autograd differentiates.  A real row with no incoming
    edge has no entry and its output is zero.  The max is taken outside
    autograd (the softmax does not depend on it).

    The reference reads its segment max at ``dst`` clamped to the last
    inner row: in a partition with fewer inner rows than the stack's
    width that row has no edge and a max of -inf, the padding edges'
    ``exp`` is inf, the forward drops them, and the backward multiplies
    their zero cotangent by inf: its parameter gradients are NaN.
    """
    n_parts = 1 if dst.dim() == 1 else dst.shape[0]
    flat = ops.segment_ids(dst.reshape(n_parts, -1), n_rows)
    heads = logits.shape[-1]
    with torch.no_grad():
        seg_max = logits.new_zeros((n_parts * (n_rows + 1), heads))
        seg_max.scatter_reduce_(0, flat[:, None].expand(-1, heads),
                                logits.reshape(-1, heads), "amax",
                                include_self=False)
    ex = torch.exp(logits - seg_max.index_select(0, flat).view_as(logits))
    denom = ops.segment_sum(ex, dst, n_rows, keep_spare=True)
    denom = denom.reshape(-1, heads).index_select(0, flat).view_as(logits)
    att = ex / torch.clamp(denom, min=1e-9)
    return torch.where((dst < n_rows)[..., None], att, 0.0)


def _gat(p: dict, adj: Adjacency, h_local: torch.Tensor) -> torch.Tensor:
    """GAT's layer before its activation: per-head scores, the edge
    softmax over each row's incoming edges, then one ``spmm_at`` of the
    attention for all the heads (the reference's loop over the heads in
    one call), the heads concatenated and projected."""
    if not isinstance(adj, EdgeListAdj):
        raise NotImplementedError(
            f"GAT's edge softmax needs flat edge ids, which the "
            f"{type(adj).__name__} backend does not expose - build the "
            "adjacency/runtime with backend='edges' for GAT.")
    n_heads = p["a_src"].shape[0]
    h_heads = (h_local @ p["w"]).unflatten(-1, (n_heads, -1))  # [.., n, H, dh]
    e_src = torch.einsum("...hd,hd->...h", h_heads, p["a_src"])
    e_dst = torch.einsum("...hd,hd->...h", h_heads, p["a_dst"])
    live = adj.dst < adj.n_rows
    logits = torch.nn.functional.leaky_relu(
        _edge_rows(e_src, adj.src)
        + _edge_rows(e_dst, torch.where(live, adj.dst, 0)), 0.2)
    att = _edge_softmax(logits, adj.dst, adj.n_rows)
    return adj.spmm_at(att, h_heads).flatten(-2) @ p["proj"]


def _layer_apply(cfg: GNNConfig, p: dict, adj: Adjacency,
                 h_local: torch.Tensor, n_inner: int,
                 is_last: bool) -> torch.Tensor:
    """One layer on a partition (``h_local [n_local, d_in]``) or a stack
    of them (``[P, n_local, d_in]``): the inner rows' new embeddings."""
    if cfg.model == "gcn":
        z = adj.spmm(h_local) @ p["w"] + p["b"]
    elif cfg.model == "sage":
        agg = adj.spmm(h_local)
        agg = agg / torch.clamp(adj.degree()[..., None], min=1.0)
        z = (h_local[..., :n_inner, :] @ p["w_self"] + agg @ p["w_neigh"]
             + p["b"])
    elif cfg.model == "gat":
        z = _gat(p, adj, h_local)
    elif cfg.model == "gin":
        agg = adj.spmm(h_local)
        z = (1.0 + p["eps"]) * h_local[..., :n_inner, :] + agg
        z = torch.relu(z @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
    else:
        _check_model(cfg.model)
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
