"""Basic NN layer functions (params are plain dicts of tensors), the JAX
package's ``nn/layers.py`` in torch.

The norms compute in f32 and return the input's dtype; ``layer_norm``'s
variance is the population variance (``jnp.var``).  ``dropout`` draws its
mask from an explicit generator.
"""
from __future__ import annotations

import torch

__all__ = ["dense", "layer_norm", "rms_norm", "dropout"]


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ params["w"]
    if "b" in params:
        y = y + params["b"]
    return y


def layer_norm(params: dict, x: torch.Tensor, eps: float = 1e-5
               ) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params.get("bias", 0.0)).to(dtype)


def rms_norm(params: dict, x: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, -1, keepdim=True) + eps)
    return (y * params["scale"]).to(dtype)


def dropout(generator: torch.Generator | None, x: torch.Tensor, rate: float,
            deterministic: bool) -> torch.Tensor:
    """Zero each entry with probability ``rate`` and scale the rest by
    ``1 / (1 - rate)``; the keep mask is drawn on ``x``'s device from
    ``generator`` (which must live there)."""
    if deterministic or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator,
                      device=x.device) < (1.0 - rate)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
