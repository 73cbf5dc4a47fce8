"""The transformer architecture zoo of the port (the JAX package's
``models/transformer``): single-device without a context, sharded on a
``DeviceMesh`` under an installed :class:`SpmdCtx`."""
from .config import ModelConfig
from .model import (init_model, forward, loss_fn, loss_and_grads,
                    train_step_fn, init_decode_cache, serve_step, param_count)
from .spmd import SpmdCtx, use_spmd, current_spmd

__all__ = ["ModelConfig", "init_model", "forward", "loss_fn",
           "loss_and_grads", "train_step_fn", "init_decode_cache",
           "serve_step", "param_count", "SpmdCtx", "use_spmd", "current_spmd"]
