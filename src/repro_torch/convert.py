"""Carry the JAX package's parameters and optimizer state across to the
port.

``jax.random`` cannot be replayed in PyTorch, so every parity test builds
its parameters with the JAX package's ``init_gnn`` (and, to resume, its
optimizer state) and hands them over here, as numpy arrays.  Nothing in
this module imports JAX: a JAX array converts through ``np.asarray`` on
the caller's side or here.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_reference", "opt_state_from_reference"]


def params_from_reference(params, device="cuda"
                          ) -> list[dict[str, torch.Tensor]]:
    """``[{"w": [din, dout], "b": [dout], ...}, ...]`` of numpy (or any
    array exposing ``__array__``) -> the same list of dicts of tensors on
    ``device`` (the card unless the caller asks for the CPU), dtypes and
    values unchanged."""
    return [{k: torch.from_numpy(np.array(v, copy=True)).to(device)
             for k, v in layer.items()} for layer in params]


def opt_state_from_reference(state, device="cuda"):
    """An optimizer state of the JAX package -> the port's: Adam's
    ``_AdamState(mu, nu, count)`` (``count`` an int32 scalar), SGD's
    momentum tree, or the empty ``()`` of plain SGD."""
    from .optim.optimizers import _AdamState
    if isinstance(state, tuple) and not state:
        return ()
    if hasattr(state, "mu") and hasattr(state, "nu"):
        return _AdamState(
            mu=params_from_reference(state.mu, device),
            nu=params_from_reference(state.nu, device),
            count=torch.tensor(int(np.asarray(state.count)),
                               dtype=torch.int32, device=device))
    return params_from_reference(state, device)
