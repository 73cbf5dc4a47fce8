"""Partitioned layer-wise full-graph inference → per-layer embedding tables.

Offline half of the serving subsystem: run the model once over the whole
graph through the partition-parallel machinery (``ExchangePlan`` tiers,
``StackedParts`` layout, any aggregation ``backend``), and scatter every
layer's stacked ``[P, NI, d]`` activations back to global ``[N, d]``
tables.  The online engine (:mod:`repro_torch.serve.engine`) then answers
node queries by row lookup instead of neighbourhood aggregation.

``tables[l]`` holds the *input* of layer ``l`` for ``l < L`` (layer 0 = the
raw input features, layers ``1..L-1`` = post-activation hidden states) and
``tables[L]`` the final logits.

The pass runs eagerly over the explicit ``[P, ...]`` batch: one
aggregation call per layer covers all P partitions (with ``ell`` or
``hybrid`` on the card, one ELL-SpMM kernel launch, and for ``hybrid``
one CSR kernel launch over the COO tail).  Saving and loading a
store come with the checkpoint slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..dist.capgnn_sim import (_build_global, _pull, _read_global,
                               _scatter, exchange_arrays, make_adj_builder)
from ..dist.exchange import ExchangePlan, StackedParts
from ..graph.partition import PartitionSet
from ..models.gnn import GNNConfig, _layer_apply

__all__ = ["EmbeddingStore", "precompute_embeddings"]


@dataclasses.dataclass
class EmbeddingStore:
    """Per-layer global embedding tables of one precompute pass.

    ``tables`` has ``num_layers + 1`` entries; entry ``l`` is ``[N, d_l]``
    with ``d_l = cfg.feat_dims[l]`` (input features, hidden states, logits).
    """
    cfg: GNNConfig
    backend: str
    tables: list[np.ndarray]

    @property
    def num_nodes(self) -> int:
        return int(self.tables[0].shape[0])

    @property
    def logits(self) -> np.ndarray:
        return self.tables[-1]

    @property
    def dims(self) -> list[int]:
        return [int(t.shape[1]) for t in self.tables]


@torch.inference_mode()
def precompute_embeddings(cfg: GNNConfig, ps: PartitionSet, sp: StackedParts,
                          xplan: ExchangePlan, params,
                          backend: str = "edges",
                          device="cuda") -> EmbeddingStore:
    """One fresh partition-parallel forward pass on ``device``, keeping
    every layer.  ``params`` must already live on ``device``.

    Same tier pulls, per-partition layer apply and backend packs as the
    JAX package's ``precompute_embeddings``, so the tables agree with it
    (held by ``tests/test_torch_serve.py``).
    """
    p, nh = sp.num_parts, sp.n_halo_max
    layers = cfg.num_layers
    feats = torch.as_tensor(sp.feats, device=device)
    halo_feats = torch.as_tensor(sp.halo_feats, device=device)
    adj_leaves, build_adj = make_adj_builder(sp, backend, device, grad=False)
    adj = build_adj(adj_leaves)
    xa = exchange_arrays(xplan, sp.n_inner_max, device, grad=False)
    un_d, loc_d, glob_d = xa["un"], xa["loc"], xa["gl"]

    h = feats
    outs = [h]
    for li, lp in enumerate(params):
        if li == 0:
            halo = halo_feats
        else:
            halo = h.new_zeros((p, nh, h.shape[-1]))
            halo = _scatter(halo, un_d["recv_halo_pos"], _pull(un_d, h),
                            un_d["recv_valid"])
            halo = _scatter(halo, loc_d["recv_halo_pos"], _pull(loc_d, h),
                            loc_d["recv_valid"])
            halo = _read_global(glob_d, _build_global(glob_d, h), halo)
        h_local = torch.cat([h, halo], dim=1)
        h = _layer_apply(cfg, lp, adj, h_local, sp.n_inner_max,
                         is_last=(li == layers - 1))
        outs.append(h)

    n = ps.graph.num_nodes
    tables = []
    for o in outs:
        o = o.cpu().numpy()
        table = np.zeros((n, o.shape[-1]), np.float32)
        for i, part in enumerate(ps.parts):
            table[part.inner_nodes] = o[i, : part.n_inner]
        tables.append(table)
    return EmbeddingStore(cfg=cfg, backend=backend, tables=tables)
