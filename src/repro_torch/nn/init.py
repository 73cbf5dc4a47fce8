"""Parameter initializers over an explicit ``torch.Generator``.

They draw on the CPU and move the result to ``device``, so a seed gives
the same parameters on every device.  They cannot replay ``jax.random``:
parity with the JAX package goes through
:func:`repro_torch.convert.params_from_reference`.
"""
from __future__ import annotations

import math

import torch

__all__ = ["glorot", "zeros_init"]


def glorot(shape: tuple[int, ...], generator: torch.Generator,
           device="cpu", dtype=torch.float32) -> torch.Tensor:
    """Uniform in ``±sqrt(6 / (fan_in + fan_out))`` (Glorot/Xavier)."""
    fan_in, fan_out = shape[-2], shape[-1]
    scale = math.sqrt(6.0 / (fan_in + fan_out))
    w = torch.empty(shape, dtype=dtype).uniform_(-scale, scale,
                                                 generator=generator)
    return w.to(device)


def zeros_init(shape: tuple[int, ...], device="cpu",
               dtype=torch.float32) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)
