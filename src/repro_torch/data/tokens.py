"""Synthetic token and embedding streams for the model zoo, a copy of
``repro.data.tokens`` (numpy only): deterministic pseudo-random token
ids with a Zipfian marginal, and the stubbed audio frontend's frame
embeddings, each array-equal to the JAX package's for the same
arguments."""

from __future__ import annotations

import numpy as np


def synthetic_token_batch(batch: int, seq_len: int, vocab: int,
                          seed: int = 0) -> np.ndarray:
    """int32 [batch, seq_len] Zipf-distributed token ids in [0, vocab)."""
    rng = np.random.default_rng(seed)
    ranks = rng.zipf(1.3, size=(batch, seq_len)).astype(np.int64)
    return np.asarray(np.minimum(ranks - 1, vocab - 1), np.int32)


def synthetic_embedding_batch(batch: int, n_frames: int, dim: int,
                              seed: int = 0) -> np.ndarray:
    """float32 [batch, n_frames, dim] unit-variance embeddings: stands in
    for the (stubbed) audio conv frontend's output."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, n_frames, dim)).astype(np.float32)
