"""Functional optimizers (SGD / Adam / AdamW) over the list-of-dicts
parameters, and a gradient utility.

The same ``(init, update)`` pairs as the JAX package's
``optim/optimizers.py``, with its formulas (Adam's bias-corrected
``sqrt(v / c2) + eps``): ``update`` returns new tensors and changes none of
its arguments.  It runs under ``torch.no_grad()``, so the parameters it
returns carry no autograd history.  ``torch.optim`` is not used: its
in-place updates and its own Adam arithmetic would not follow the
reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

__all__ = ["Optimizer", "sgd", "adam", "adamw", "clip_by_global_norm",
           "tree_map", "tree_leaves"]


def tree_map(fn, tree, *rest):
    """``fn`` over the tensors of nested lists, tuples (named tuples too:
    the Adam state) and dicts (the parameter layout ``[{"w": ..., "b":
    ...}, ...]``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, v, *(r[i] for r in rest))
                 for i, v in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The tensors of ``tree`` in :func:`tree_map`'s order."""
    out = []
    tree_map(out.append, tree)
    return out


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """(init, update) pair; update returns (new_params, new_state)."""
    init: Callable
    update: Callable


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(torch.zeros_like, params)

    @torch.no_grad()
    def update(grads, state, params, step=None):
        del step
        if momentum == 0.0:
            return tree_map(lambda p, g: p - lr * g, params, grads), ()
        new_vel = tree_map(lambda v, g: momentum * v + g, state, grads)
        new_params = tree_map(lambda p, v: p - lr * v, params, new_vel)
        return new_params, new_vel

    return Optimizer(init, update)


class _AdamState(NamedTuple):
    mu: object
    nu: object
    count: torch.Tensor      # int32 scalar on the parameters' device


def _adam_like(lr, b1, b2, eps, weight_decay) -> Optimizer:
    def init(params):
        device = tree_leaves(params)[0].device
        return _AdamState(mu=tree_map(torch.zeros_like, params),
                          nu=tree_map(torch.zeros_like, params),
                          count=torch.zeros((), dtype=torch.int32,
                                            device=device))

    @torch.no_grad()
    def update(grads, state, params, step=None):
        count = state.count + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
        c1 = 1 - b1 ** count.float()
        c2 = 1 - b2 ** count.float()

        def upd(p, m, v):
            step_ = lr * (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay:
                step_ = step_ + lr * weight_decay * p
            return p - step_

        new_params = tree_map(upd, params, mu, nu)
        return new_params, _AdamState(mu, nu, count)

    return Optimizer(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
         ) -> Optimizer:
    return _adam_like(lr, b1, b2, eps, weight_decay=0.0)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    return _adam_like(lr, b1, b2, eps, weight_decay)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """``(grads scaled to a global norm of at most max_norm, the norm)``."""
    gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2)
                           for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), gnorm
