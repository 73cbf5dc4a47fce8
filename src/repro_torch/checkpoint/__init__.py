"""Checksummed checkpoints in the JAX package's file format (see
:mod:`.checkpoint`)."""
from .checkpoint import (CheckpointCorruptError, latest_step,
                         load_checkpoint, save_checkpoint,
                         verify_checkpoint)

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step",
           "verify_checkpoint", "CheckpointCorruptError"]
