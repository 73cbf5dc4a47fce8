"""Model assembly: embedding -> block runs -> LM head, the JAX package's
``models/transformer/model.py`` in torch.

Entry points:
- ``init_model(cfg, generator, device)``  parameter tree
- ``forward(cfg, params, batch)``         train/prefill logits
- ``loss_fn(cfg, params, batch)``         (loss + 0.01 * aux, metrics)
- ``train_step_fn(cfg, opt)``             (params, opt_state, batch) step
- ``init_decode_cache(cfg, B, S, device)`` stacked per-run caches
- ``serve_step(cfg, params, cache, tokens, pos)``  one-token decode

The parameter tree is the reference's: ``params["runs"]`` holds one entry
per ``cfg.block_runs()``, each leaf stacked over the run's layers, so JAX
parameters and checkpoints carry across unchanged.  Where the reference
scans a run with ``lax.scan``, a Python loop walks its layers here (the
leaves unbound once per run, so the backward stacks each leaf's gradient
once); ``cfg.remat`` checkpoints each layer while autograd records.

Under an installed :class:`~.spmd.SpmdCtx` the parameters and the batch
are DTensors on its mesh (``launch.sharding.shard_params``): the
reference's five ``constrain`` calls redistribute the embeddings, each
layer's output and the logits to the context's layouts, and everything
runs in :func:`~.spmd.spmd_region` (the plain tensors the model makes act
as replicated).  The entry points are unchanged; the backward of
``loss_and_grads`` runs in the same region.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ...nn import normal_init
from ...optim.optimizers import tree_leaves, tree_map
from .blocks import (apply_block, init_block, init_block_cache, norm_apply,
                     torch_dtype)
from .config import ModelConfig
from .spmd import (P, constrain, from_local_as, is_dtensor, matmul,
                   shard_offset, spec_of, spmd_region, to_local_as)

__all__ = ["init_model", "forward", "loss_fn", "loss_and_grads",
           "train_step_fn", "init_decode_cache", "serve_step", "param_count"]


def _stack_trees(trees: list, like=None):
    """The leaves of ``trees`` stacked on a new dim 0.  With ``like`` (a
    stacked tree of DTensors: the caches the layers read), each stack of
    DTensors is built from local shards in ``like``'s layout — DTensor's
    own ``stack`` may replicate layers whose layouts differ."""
    if like is None:
        return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])
    return tree_map(lambda lk, *xs: _stack_like(xs, lk), like, *trees)


def _stack_like(xs, like):
    if not is_dtensor(like):
        return torch.stack(xs)
    from torch.distributed.tensor import DTensor, Shard
    mesh = like.device_mesh
    inner = [Shard(p.dim - 1) if isinstance(p, Shard) else p
             for p in like.placements]
    local = torch.stack([x.redistribute(mesh, inner).to_local()
                         for x in xs])
    return DTensor.from_local(local, mesh, like.placements, run_check=False,
                              shape=like.shape, stride=like.stride())


def _unstack(tree, n: int) -> list:
    """The ``n`` layer trees of a run's stacked ``tree`` (views)."""
    parts = [leaf.unbind(0) for leaf in tree_leaves(tree)]
    out = []
    for i in range(n):
        it = iter([p[i] for p in parts])
        out.append(tree_map(lambda _: next(it), tree))
    return out


def init_model(cfg: ModelConfig, generator: torch.Generator | None,
               device="cuda") -> dict:
    """The parameter tree of ``cfg``, drawn from ``generator`` (on its
    device, then moved to ``device``: the same seed gives the same
    parameters on every device).  On ``torch.device("meta")`` nothing is
    drawn or allocated."""
    dt = torch_dtype(cfg)
    params: dict[str, Any] = {
        "embed": normal_init((cfg.padded_vocab, cfg.d_model), generator,
                             device=device, dtype=dt),
        "final_norm": {"scale": torch.ones((cfg.d_model,),
                                           dtype=torch.float32,
                                           device=device)},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal_init((cfg.d_model, cfg.padded_vocab),
                                        generator, device=device, dtype=dt)
    params["runs"] = [
        _stack_trees([init_block(generator, cfg, kind, device)
                      for _ in range(length)])
        for kind, start, length in cfg.block_runs()]
    return params


def param_count(cfg: ModelConfig) -> int:
    """Exact parameter count from a shape-only build on the meta device
    (no allocation)."""
    shapes = init_model(cfg, None, device="meta")
    return int(sum(np.prod(t.shape) for t in tree_leaves(shapes)))


def _embed_scale(cfg: ModelConfig) -> float:
    """``sqrt(d_model)`` rounded to f32 and then to the model's dtype, as
    the reference multiplies by it (45.25 at d = 2048 in bf16)."""
    return float(torch.tensor(math.sqrt(cfg.d_model),
                              dtype=torch.float32).to(torch_dtype(cfg)))


def _lookup(embed, tokens):
    """``embed[tokens]``; on DTensors ``F.embedding`` (the same rows),
    whose sharding rule looks a vocab-sharded table up where it lies (a
    masked local lookup, summed over the shards) instead of gathering
    it."""
    if is_dtensor(embed):
        return torch.nn.functional.embedding(tokens.long(), embed)
    return embed[tokens.long()]


def _embed(cfg: ModelConfig, params, batch) -> torch.Tensor:
    x = _lookup(params["embed"], batch["tokens"]) * _embed_scale(cfg)
    if cfg.vision_tokens and "patches" in batch:
        # VLM stub carve-out: pre-computed patch embeddings are prepended.
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
    return x


def _head(cfg: ModelConfig, params) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def forward(cfg: ModelConfig, params, batch) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Full-sequence forward.  Returns (logits [B,S,Vpad], aux_loss)."""
    with spmd_region():
        x = constrain(_embed(cfg, params, batch))
        positions = torch.arange(x.shape[1], device=x.device)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        remat = cfg.remat and torch.is_grad_enabled()
        for run_params, (kind, start, length) in zip(params["runs"],
                                                     cfg.block_runs()):
            for p_layer in _unstack(run_params, length):
                if remat:
                    x, _, aux_l = checkpoint(apply_block, cfg, kind, p_layer,
                                             x, positions,
                                             use_reentrant=False)
                else:
                    x, _, aux_l = apply_block(cfg, kind, p_layer, x,
                                              positions)
                x = constrain(x)
                aux_total = aux_total + aux_l
        x = norm_apply(cfg, params["final_norm"], x)
        return constrain(matmul(x, _head(cfg, params)), "logits"), aux_total


def loss_fn(cfg: ModelConfig, params, batch) -> tuple[torch.Tensor, dict]:
    with spmd_region():
        return _loss(cfg, params, batch)


def _loss(cfg: ModelConfig, params, batch):
    logits, aux = forward(cfg, params, batch)
    labels = batch["labels"]
    if cfg.vision_tokens and "patches" in batch:
        logits = logits[:, batch["patches"].shape[1]:]
    if is_dtensor(logits):
        nll = _sharded_nll(logits, labels)
    else:
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    mask = batch.get("loss_mask")
    if mask is None:
        loss = nll.mean()
    else:
        loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    total = loss + 0.01 * aux
    return total, {"loss": loss, "aux": aux}


def _sharded_nll(logits, labels):
    """The per-token negative log-likelihood of DTensor logits, on local
    shards: with the vocabulary sharded, each rank takes its slice's max,
    sum of exponentials and target logit, and the three are reduced over
    the vocabulary's mesh axes ([B, S] values) instead of gathering the
    logits (vocab-parallel cross-entropy)."""
    import torch.distributed._functional_collectives as funcol
    from ...dist.collectives import mesh_all_reduce
    mesh = logits.device_mesh
    spec = spec_of(logits)
    vocab = spec[-1]
    axes = () if vocab is None else (
        vocab if isinstance(vocab, tuple) else (vocab,))
    lspec = P(*spec[:-1])
    ll = to_local_as(logits, spec).float()
    lab = to_local_as(labels, lspec).long()
    off = shard_offset(logits, logits.ndim - 1)
    m = ll.detach().amax(-1)
    for a in axes:
        m = funcol.wait_tensor(funcol.all_reduce(m, "max",
                                                 mesh.get_group(a)))
    se = torch.exp(ll - m[..., None]).sum(-1)
    inside = (lab >= off) & (lab < off + ll.shape[-1])
    tgt = torch.gather(ll, -1, (lab - off).clamp(0, max(ll.shape[-1] - 1, 0))
                       [..., None])[..., 0] * inside
    for a in axes:
        g = mesh.get_group(a)
        se = mesh_all_reduce(se, g, varying=False)
        tgt = mesh_all_reduce(tgt, g, varying=False)
    nll = torch.log(se) + m - tgt
    return from_local_as(nll, lspec, labels.shape)


def _as_leaf(x, like):
    """A DTensor in ``like``'s layout: a gradient's partial sums over the
    token axes reduced (all-reduced where the leaf is replicated,
    reduce-scattered where it is sharded, as data parallelism's gradient
    reduction does); an updated parameter or moment back in the layout it
    came in."""
    if is_dtensor(x) and x.placements != like.placements:
        return x.redistribute(like.device_mesh, like.placements)
    return x


def loss_and_grads(cfg: ModelConfig, params, batch):
    """``(total, metrics, grads)``: ``loss_fn`` and its gradient with
    respect to every leaf of ``params`` (a tree of the same structure;
    a leaf the loss does not reach gets zeros, as ``jax.grad`` gives)."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
    with torch.enable_grad(), spmd_region():
        total, metrics = loss_fn(cfg, leaves, batch)
        flat = tree_leaves(leaves)
        got = torch.autograd.grad(total, flat, allow_unused=True)
    got = iter([torch.zeros_like(t) if g is None else _as_leaf(g, t)
                for t, g in zip(flat, got)])
    grads = tree_map(lambda _: next(got), params)
    return (total.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def train_step_fn(cfg: ModelConfig, opt):
    """Returns step(params, opt_state, batch) -> (params, opt_state, metrics)."""

    def step(params, opt_state, batch):
        _, metrics, grads = loss_and_grads(cfg, params, batch)
        with spmd_region():
            params2, opt_state2 = opt.update(grads, opt_state, params)
            # sharded: the state leaves the step in the layout it came in
            params2 = tree_map(_as_leaf, params2, params)
            opt_state2 = tree_map(_as_leaf, opt_state2, opt_state)
        return params2, opt_state2, metrics

    return step


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device="cuda") -> list:
    """Per-run stacked caches."""
    return [_stack_trees([init_block_cache(cfg, kind, batch, max_len, device)
                          for _ in range(length)])
            for kind, start, length in cfg.block_runs()]


def serve_step(cfg: ModelConfig, params, caches: list, tokens: torch.Tensor,
               pos):
    """Decode one token.  tokens [B,1] int, pos the current position (the
    number of tokens already in the cache: an int, or a 0-d tensor read
    once).  Returns (logits [B, Vpad], new caches); the caches passed in
    are left as they were."""
    pos = int(pos)
    with spmd_region():
        x = constrain(_lookup(params["embed"], tokens) * _embed_scale(cfg))
        new_caches = []
        for run_params, run_cache, (kind, start, length) in zip(
                params["runs"], caches, cfg.block_runs()):
            updated = []
            for p_layer, c_layer in zip(_unstack(run_params, length),
                                        _unstack(run_cache, length)):
                x, c2, _ = apply_block(cfg, kind, p_layer, x, None,
                                       cache=c_layer, pos=pos)
                x = constrain(x)
                updated.append(c2)
            new_caches.append(_stack_trees(updated, like=run_cache))
        x = norm_apply(cfg, params["final_norm"], x)
        logits = matmul(x, _head(cfg, params))[:, 0]
        return logits, new_caches
