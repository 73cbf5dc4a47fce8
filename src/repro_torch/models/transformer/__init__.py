"""The transformer architecture zoo of the port, single-device (the JAX
package's ``models/transformer`` without its ``spmd`` module)."""
from .config import ModelConfig
from .model import (init_model, forward, loss_fn, loss_and_grads,
                    train_step_fn, init_decode_cache, serve_step, param_count)

__all__ = ["ModelConfig", "init_model", "forward", "loss_fn",
           "loss_and_grads", "train_step_fn", "init_decode_cache",
           "serve_step", "param_count"]
