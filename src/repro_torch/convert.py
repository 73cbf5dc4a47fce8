"""Carry the JAX package's parameters across to the port.

``jax.random`` cannot be replayed in PyTorch, so every parity test builds
its parameters with the JAX package's ``init_gnn`` and hands them over
here, as numpy arrays.  Nothing in this module imports JAX: a JAX array
converts through ``np.asarray`` on the caller's side or here.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_reference"]


def params_from_reference(params, device="cpu") -> list[dict[str, torch.Tensor]]:
    """``[{"w": [din, dout], "b": [dout], ...}, ...]`` of numpy (or any
    array exposing ``__array__``) -> the same list of dicts of tensors on
    ``device``, dtypes and values unchanged."""
    return [{k: torch.from_numpy(np.array(v, copy=True)).to(device)
             for k, v in layer.items()} for layer in params]
