"""Synthetic token pipeline for the transformer architecture zoo.

Deterministic, seedable, host-side generator producing sharded global
batches — the stand-in for a production data loader (the container is
offline).  For VLM/audio archs it also fabricates the stubbed frontend
embeddings (patch / codec-frame embeddings) per the brief's carve-out.

Numpy only, a copy of the JAX package's ``data/token_stream.py``: the same
seed gives the same batches in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

__all__ = ["TokenStream", "synthetic_token_batches"]


@dataclasses.dataclass
class TokenStream:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def __iter__(self) -> Iterator[dict]:
        return synthetic_token_batches(self.vocab_size, self.seq_len,
                                       self.global_batch, self.seed)


def synthetic_token_batches(vocab_size: int, seq_len: int, global_batch: int,
                            seed: int = 0) -> Iterator[dict]:
    """Zipfian token ids (realistic embedding-gather skew) + next-token labels."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    while True:
        tokens = rng.choice(vocab_size, size=(global_batch, seq_len), p=probs)
        tokens = tokens.astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = 0
        yield {"tokens": tokens, "labels": labels}
