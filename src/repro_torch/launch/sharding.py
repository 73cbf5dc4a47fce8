"""Sharding rules: parameter specs, activation specs, input specs — the
JAX package's ``launch/sharding.py`` over a ``torch.distributed``
``DeviceMesh``.

Rules are path-name based over the parameter tree (nested dicts and
lists, named tuples by field); a spec is the reference's PartitionSpec
(:class:`~repro_torch.models.transformer.spmd.P`), and
:func:`~repro_torch.models.transformer.spmd.placements` turns it into
DTensor placements.  The reference's GSPMD pads non-divisible dims (40
q-heads or 2 kv-heads over a 16-way model axis); DTensor shards them
unevenly, ceil-sized shards first, which the roofline accounting treats
as measured waste rather than hiding it.

:func:`shard_params` is the counterpart of the reference's ``device_put``
with shardings: it places a plain parameter or optimizer-state tree on
the mesh by these specs.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..models.transformer import ModelConfig, SpmdCtx
from ..models.transformer.model import init_decode_cache, init_model
from ..models.transformer.spmd import P, placements
from ..optim.optimizers import tree_map
from .mesh import dp_axes, mesh_sizes

__all__ = ["param_specs", "param_shardings", "make_spmd_ctx", "batch_specs",
           "decode_state_specs", "abstract_params", "attach", "shard_params",
           "place", "ShapeDtypeStruct", "tree_map_with_path",
           "per_device_bytes", "shard_shape"]

M = "model"


def _leaf_spec(path: tuple[str, ...], leaf, ep_experts: bool) -> P:
    """PartitionSpec for one (unstacked) param leaf, by name rules.

    ``ep_experts``: expert count divides the model axis -> expert-parallel
    layout [E/model, D/data, F]; otherwise tensor-parallel experts
    [E, D, F/model].
    """
    name = path[-1]
    parent = path[-2] if len(path) >= 2 else ""
    nd = leaf.ndim

    def spec(*axes):
        return P(*(list(axes) + [None] * nd)[:nd])

    if name == "embed":
        return spec(M, None)
    if name == "lm_head":
        return spec(None, M)
    if name in ("scale", "bias", "eps"):
        return spec(None)
    # attention
    if name in ("wq", "wk", "wv") and parent == "attn":
        return spec(None, M)
    if name in ("bq", "bk", "bv"):
        return spec(M)
    if name == "wo":
        return spec(M, None)
    if name in ("wdq", "wuq", "wukv"):
        return spec(None, M)
    if name == "wdkv":
        return spec(None, None)
    # ffn / shared expert
    if name in ("wg", "wu", "wi") and nd == 2:
        return spec(None, M)
    if name == "wd" and nd == 2:
        return spec(M, None)
    if name == "bi":
        return spec(M)
    # moe experts [E, D, F] / [E, F, D]
    if nd == 3 and name in ("wg", "wu"):
        return spec(M, "data", None) if ep_experts else spec(None, None, M)
    if nd == 3 and name == "wd":
        return spec(M, None, "data") if ep_experts else spec(None, M, None)
    if name == "router":
        return spec(None, None)
    # mlstm
    if name in ("wz",):
        return spec(None, M)
    if name == "wif":
        return spec(None, None)
    # slstm
    if name == "r":
        return spec(None)
    # mamba
    if name == "win":
        return spec(None, M)
    if name == "wout":
        return spec(M, None)
    if name in ("wbc", "wdt1", "a_log"):
        return spec(M, None)
    if name in ("conv", "conv_b", "wdt2", "dt_b", "d_skip"):
        return spec(None)
    if name == "wg" and parent != "attn":  # slstm gates [D, 4D]
        return spec(None, M)
    return spec(None)


def tree_map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over nested dicts, lists, tuples and named
    tuples; a path entry is a dict key, ``"[i]"`` for a list or tuple
    position, or a named tuple's field name (the names the reference's
    ``_path_names`` reads from a JAX key path).  A spec is a leaf."""
    if isinstance(tree, P):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_specs(cfg: ModelConfig, params_shape, *, model_size: int = 16,
                data_size: int = 16, zero_data: bool = False) -> Any:
    """PartitionSpec tree matching the param tree (handles the stacked
    run axis: anything under 'runs' gets a leading None).

    ``zero_data``: additionally shard the largest still-unsharded,
    data-divisible dim over 'data' (ZeRO-1 — used for optimizer moments).
    Every chosen axis is validated against the dim size (input shardings
    must divide evenly) and dropped if it does not fit.
    """
    ep_experts = cfg.n_experts > 0 and cfg.n_experts % model_size == 0

    def one(names, leaf):
        stacked = "runs" in names
        base_names = tuple(n for n in names if not n.startswith("["))
        shape = tuple(leaf.shape)

        class V:
            ndim = len(shape) - (1 if stacked else 0)
        sp = _leaf_spec(base_names if base_names else names, V, ep_experts)
        if stacked:
            sp = P(*([None] + list(sp)))
        # validate divisibility; drop axes that do not fit
        sizes = {"model": model_size, "data": data_size}
        ent = []
        for dim, ax in zip(shape, tuple(sp) + (None,) * len(shape)):
            if ax is not None and dim % sizes.get(ax, 1) != 0:
                ax = None
            ent.append(ax)
        if zero_data and "data" not in ent:
            start = 1 if stacked else 0
            cands = [i for i in range(start, len(shape))
                     if ent[i] is None and shape[i] % data_size == 0]
            if cands:
                big = max(cands, key=lambda i: shape[i])
                ent[big] = "data"
        return P(*ent)

    return tree_map_with_path(one, params_shape)


def param_shardings(mesh, cfg: ModelConfig, params_shape,
                    zero_data: bool = False):
    """The spec tree of :func:`param_specs` at ``mesh``'s sizes (the
    reference's ``NamedSharding`` tree; :func:`placements` turns a spec
    into DTensor placements)."""
    sizes = mesh_sizes(mesh)
    return param_specs(cfg, params_shape, model_size=sizes.get("model", 1),
                       data_size=sizes.get("data", 1), zero_data=zero_data)


def abstract_params(cfg: ModelConfig):
    """The parameter tree on the ``meta`` device: shapes and dtypes, no
    storage (the reference's ``eval_shape`` of ``init_model``)."""
    return init_model(cfg, None, device="meta")


@dataclasses.dataclass(frozen=True)
class ShapeDtypeStruct:
    """A leaf's global shape, dtype and spec (``jax.ShapeDtypeStruct``
    with a sharding)."""
    shape: tuple
    dtype: torch.dtype
    sharding: P | None = None


def attach(shape_tree, sharding_tree):
    """``ShapeDtypeStruct``s of ``shape_tree``'s leaves (tensors on any
    device, meta too) with the specs of ``sharding_tree``."""
    return tree_map(lambda s, sh: ShapeDtypeStruct(tuple(s.shape), s.dtype,
                                                   sh),
                    shape_tree, sharding_tree)


def shard_shape(shape, spec, sizes: dict) -> tuple:
    """The first shard's shape of a ``shape`` leaf under ``spec`` (ceil
    division: DTensor's and GSPMD's largest shard)."""
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if ax is None else (ax if isinstance(ax, tuple) else (ax,))
        n = int(np.prod([sizes.get(a, 1) for a in axes])) if axes else 1
        out.append(-(-dim // n))
    return tuple(out)


def per_device_bytes(struct_tree, sizes: dict) -> int:
    """Bytes one device holds of a tree of :class:`ShapeDtypeStruct`s (the
    largest shard of each leaf)."""
    total = 0
    for s in _struct_leaves(struct_tree):
        n = int(np.prod(shard_shape(s.shape, s.sharding or P(), sizes)))
        total += n * torch.empty((), dtype=s.dtype).element_size()
    return total


def _struct_leaves(tree) -> list:
    if isinstance(tree, ShapeDtypeStruct):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _struct_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _struct_leaves(v)]
    return []


def make_spmd_ctx(mesh, cfg: ModelConfig, shape_kind: str,
                  seq_shard: bool, act_mode: str = "baseline") -> SpmdCtx:
    """Activation sharding policy.

    train/prefill: batch over dp; hidden sequence dim sharded over 'model'
    between blocks (Megatron-style sequence parallelism — keeps the saved
    residuals at 1/16 size).  long-context (seq_shard): sequence over dp
    instead of batch.  decode: batch over dp.

    ``act_mode='block_sp'`` keeps the same between-block residual layout
    but adds per-block constraints that gather the sequence once and shard
    heads / SSM channels over 'model' inside attention and recurrent scans.
    """
    dp = dp_axes(mesh)
    if seq_shard:
        act = P(None, dp, None)
        logits = P(None, dp, None)
    elif shape_kind in ("train", "prefill"):
        act = P(dp, M, None)
        logits = P(dp, None, M)
    else:
        act = P(dp, None, None)
        logits = P(dp, None, M)
    return SpmdCtx(mesh=mesh, dp_axes=dp, act_spec=act, logits_spec=logits,
                   block_sp=(act_mode == "block_sp"
                             and shape_kind in ("train", "prefill")
                             and not seq_shard))


def batch_specs(mesh, cfg: ModelConfig, seq_len: int, batch: int,
                shape_kind: str, seq_shard: bool):
    """ShapeDtypeStructs (with specs) for the input batch."""
    dp = dp_axes(mesh)
    tok_spec = P(None, dp) if seq_shard else P(dp, None)
    s_text = seq_len - (cfg.vision_tokens or 0)
    batch_tree = {
        "tokens": ShapeDtypeStruct((batch, s_text), torch.int32, tok_spec),
        "labels": ShapeDtypeStruct((batch, s_text), torch.int32, tok_spec),
    }
    if cfg.vision_tokens:
        batch_tree["patches"] = ShapeDtypeStruct(
            (batch, cfg.vision_tokens, cfg.d_model), getattr(torch, cfg.dtype),
            P(dp, None, None))
    return batch_tree


def _cache_leaf_spec(path_names, leaf_shape, cfg, seq_shard, dp,
                     sizes) -> P:
    """Sharding for decode-cache leaves (divisibility-checked; for k/v the
    model axis lands on kv-heads when divisible, else on head_dim)."""
    name = path_names[-1] if path_names else ""
    nd = len(leaf_shape)
    m_size = sizes.get("model", 1)

    def fit(sp):
        ent = []
        for dim, ax in zip(leaf_shape, tuple(sp) + (None,) * nd):
            if ax is not None:
                axes = ax if isinstance(ax, tuple) else (ax,)
                n = 1
                for a in axes:
                    n *= sizes.get(a, 1)
                if dim % n != 0:
                    ax = None
            ent.append(ax)
        return P(*ent)

    if name in ("k", "v"):          # [L, B, W, nkv, hd]
        head_ax = M if leaf_shape[3] % m_size == 0 else None
        dim_ax = None if head_ax else (M if leaf_shape[4] % m_size == 0 else None)
        if seq_shard:
            return fit(P(None, None, dp, head_ax, dim_ax))
        return fit(P(None, dp, None, head_ax, dim_ax))
    if name == "pos":               # [L, B, W]
        return fit(P(None, None, dp) if seq_shard else P(None, dp, None))
    if name == "ckv":               # [L, B, S, kvl]
        return fit(P(None, None, dp, M) if seq_shard
                   else P(None, dp, None, M))
    if name == "kr":                # [L, B, S, rdim]
        return fit(P(None, None, dp, None) if seq_shard
                   else P(None, dp, None, None))
    if name == "conv":              # [L, B, CW-1, DI]
        return fit(P(None, None if seq_shard else dp, None, M))
    if name == "h" and nd == 4:     # mamba state [L, B, DI, N]
        return fit(P(None, None if seq_shard else dp, M, None))
    # mlstm state c [L,B,H,dk,dv] / n [L,B,H,dk]; slstm states [L,B,D]
    specs = [None, None if seq_shard else dp] + [None] * (nd - 2)
    return fit(P(*specs))


def decode_state_specs(mesh, cfg: ModelConfig, batch: int,
                       max_len: int, seq_shard: bool):
    """ShapeDtypeStructs for the stacked decode caches."""
    dp = dp_axes(mesh)
    sizes = mesh_sizes(mesh)
    cache_shape = init_decode_cache(cfg, batch, max_len, device="meta")

    def one(names, leaf):
        sp = _cache_leaf_spec(names, tuple(leaf.shape), cfg, seq_shard, dp,
                              sizes)
        return ShapeDtypeStruct(tuple(leaf.shape), leaf.dtype, sp)

    return tree_map_with_path(one, cache_shape)


def _place(t: torch.Tensor, mesh, spec) -> torch.Tensor:
    from torch.distributed.tensor import distribute_tensor
    # every rank holds the whole tensor (the same seed or checkpoint), so
    # each takes its own chunk with no collective
    return distribute_tensor(t, mesh, placements(mesh, spec, t.ndim),
                             src_data_rank=None)


def place(tree, mesh, spec_tree):
    """``tree``'s tensors as DTensors on ``mesh`` by ``spec_tree`` (a tree
    of specs of the same structure, or of :class:`ShapeDtypeStruct`s)."""
    def one(t, sp):
        if isinstance(sp, ShapeDtypeStruct):
            sp = sp.sharding
        return _place(t, mesh, sp if sp is not None else P())
    return tree_map(one, tree, spec_tree)


def shard_params(params, mesh, cfg: ModelConfig, zero_data: bool = False):
    """A plain parameter tree (or an optimizer state: Adam's moments get
    the same rules, its ``count`` is replicated) as DTensors on ``mesh``,
    each leaf by :func:`param_specs` at the mesh's sizes: the reference's
    ``device_put`` with ``param_shardings``.  Every rank passes the whole
    tree and keeps its own shards."""
    return place(params, mesh, param_shardings(mesh, cfg, params,
                                               zero_data=zero_data))
