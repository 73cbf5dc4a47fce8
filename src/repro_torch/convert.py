"""Carry the JAX package's parameters and optimizer state across to the
port.

``jax.random`` cannot be replayed in PyTorch, so every parity test builds
its parameters with the JAX package's ``init_gnn`` / ``init_model`` (and,
to resume, its optimizer state) and hands them over here, as numpy arrays.
Nothing in this module imports JAX: a JAX array converts through
``np.asarray`` on the caller's side or here.  A bfloat16 leaf (an
``ml_dtypes.bfloat16`` array, which ``torch.from_numpy`` rejects) comes
through its ``uint16`` view, as the checkpoint module stores it.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_reference", "lm_params_from_reference",
           "opt_state_from_reference"]


def _tensor(leaf, device) -> torch.Tensor:
    """One array leaf as a tensor on ``device``, dtype and values
    unchanged."""
    arr = np.array(leaf, copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _tree(tree, device):
    """Nested dicts, lists and tuples (named tuples keep their type: an
    ``MlstmState`` stays one) of arrays -> the same tree of tensors."""
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_tree(v, device) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return _tensor(tree, device)


def params_from_reference(params, device="cuda"
                          ) -> list[dict[str, torch.Tensor]]:
    """``[{"w": [din, dout], "b": [dout], ...}, ...]`` of numpy (or any
    array exposing ``__array__``) -> the same list of dicts of tensors on
    ``device`` (the card unless the caller asks for the CPU), dtypes and
    values unchanged."""
    return [{k: _tensor(v, device) for k, v in layer.items()}
            for layer in params]


def lm_params_from_reference(tree, device="cuda") -> dict:
    """A transformer parameter tree of the JAX package (``init_model``'s
    ``{"embed", "final_norm", ["lm_head"], "runs": [...]}``, each run's
    leaves stacked over its layers) -> the same tree of tensors on
    ``device``, structure, shapes and dtypes (bfloat16 included)
    unchanged.  Any other tree of arrays (a decode cache) converts the
    same way."""
    return _tree(tree, device)


def opt_state_from_reference(state, device="cuda"):
    """An optimizer state of the JAX package -> the port's: Adam's
    ``_AdamState(mu, nu, count)`` (``count`` an int32 scalar), SGD's
    momentum tree, or the empty ``()`` of plain SGD.  The moment trees
    may be GNN layer lists or transformer trees."""
    from .optim.optimizers import _AdamState
    if isinstance(state, tuple) and not state:
        return ()
    if hasattr(state, "mu") and hasattr(state, "nu"):
        return _AdamState(
            mu=_tree(state.mu, device), nu=_tree(state.nu, device),
            count=torch.tensor(int(np.asarray(state.count)),
                               dtype=torch.int32, device=device))
    return _tree(state, device)
