"""Deterministic synthetic LM data (port of ``lm_batch`` and
``frames_batch`` in ``repro/data/synthetic.py``).

The generator is a pure function of (seed, step, shard), so a restart at
step N regenerates the identical stream (the recovery manager replays
data) and data-parallel hosts pull disjoint shards without coordination.
It draws from numpy's PCG64 seeded with (seed, step, shard); the
reference draws from JAX's threefry, so the two packages give different
tokens under the same Markov rule, and other frames (the parity tests
feed both one batch).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def lm_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
             shard: int = 0) -> Dict[str, torch.Tensor]:
    """Markov-chain token stream: the next token is (tok * 17 + 7) % vocab,
    replaced by a uniform random token with probability 0.1. Learnable
    low-entropy structure, so small models visibly reduce loss. Returns
    {"tokens": (batch, seq) int64} on the host."""
    rng = np.random.default_rng([seed, step, shard])
    tokens = np.empty((batch, seq), np.int64)
    tokens[:, 0] = rng.integers(0, vocab, batch)
    noise = rng.random((batch, seq - 1)) < 0.1
    rand = rng.integers(0, vocab, (batch, seq - 1))
    for i in range(1, seq):
        nxt = (tokens[:, i - 1] * 17 + 7) % vocab
        tokens[:, i] = np.where(noise[:, i - 1], rand[:, i - 1], nxt)
    return {"tokens": torch.from_numpy(tokens)}


def frames_batch(seed: int, step: int, batch: int, seq: int, cfg,
                 shard: int = 0) -> Dict[str, torch.Tensor]:
    """Encoder-decoder batch: synthetic frame embeddings 0.1 * N(0, 1)
    (batch, seq, d_model) f32 and ``lm_batch`` decoder tokens of length
    max(2, seq // cfg.dec_ratio), on the host."""
    rng = np.random.default_rng([seed, step, shard, 1])
    frames = 0.1 * rng.standard_normal((batch, seq, cfg.d_model), np.float32)
    toks = lm_batch(seed, step, batch, max(2, seq // cfg.dec_ratio), cfg.vocab,
                    shard=shard)["tokens"]
    return {"frames": torch.from_numpy(frames), "tokens": toks}
