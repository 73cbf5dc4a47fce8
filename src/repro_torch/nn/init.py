"""Parameter initializers over an explicit ``torch.Generator``.

They draw on the generator's device (the CPU for ``torch.Generator()``)
and move the result to ``device``, so a seed gives the same parameters on
every device.  On ``torch.device("meta")`` they draw nothing and give
shape-only tensors (``param_count`` of a 671B config allocates nothing).
They cannot replay ``jax.random``: parity with the JAX package goes through
:mod:`repro_torch.convert`.
"""
from __future__ import annotations

import math

import torch

__all__ = ["glorot", "he", "normal_init", "zeros_init"]


def _is_meta(device) -> bool:
    return torch.device(device).type == "meta"


def glorot(shape: tuple[int, ...], generator: torch.Generator,
           device="cpu", dtype=torch.float32) -> torch.Tensor:
    """Uniform in ``±sqrt(6 / (fan_in + fan_out))`` (Glorot/Xavier)."""
    fan_in, fan_out = shape[-2], shape[-1]
    scale = math.sqrt(6.0 / (fan_in + fan_out))
    w = torch.empty(shape, dtype=dtype).uniform_(-scale, scale,
                                                 generator=generator)
    return w.to(device)


def _normal(shape, generator, device, dtype, stddev: float) -> torch.Tensor:
    if _is_meta(device):
        return torch.empty(shape, dtype=dtype, device="meta")
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    w.normal_(generator=generator)
    return (w * stddev).to(device=device, dtype=dtype)


def he(shape: tuple[int, ...], generator: torch.Generator, device="cpu",
       dtype=torch.float32) -> torch.Tensor:
    """Normal with standard deviation ``sqrt(2 / fan_in)`` (He/Kaiming)."""
    return _normal(shape, generator, device, dtype,
                   math.sqrt(2.0 / shape[-2]))


def normal_init(shape: tuple[int, ...], generator: torch.Generator,
                stddev: float = 0.02, device="cpu",
                dtype=torch.float32) -> torch.Tensor:
    """Normal with standard deviation ``stddev``, drawn in f32 and then
    rounded to ``dtype``."""
    return _normal(shape, generator, device, dtype, stddev)


def zeros_init(shape: tuple[int, ...], device="cpu",
               dtype=torch.float32) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)
