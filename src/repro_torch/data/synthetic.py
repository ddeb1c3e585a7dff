"""Deterministic synthetic datasets (port of ``repro/data/synthetic.py``).

Every generator is a pure function of (seed, step, shard), so a restart at
step N regenerates the identical stream (the recovery manager replays
data) and data-parallel hosts pull disjoint shards without coordination:

* ``lm_batch``     — Zipf-ish Markov token stream (LM pretraining proxy)
* ``frames_batch`` — encoder-decoder frames and decoder tokens
* ``teacher_mlp``  — teacher-student classification
* ``point_cloud``  — clustered 3-D point clouds (PointNet proxy)
* ``sine_mixture`` — multivariate time-series forecasting (paper Table 5)
* ``image_like``   — low-res "images" with class-dependent textures

``lm_batch`` and ``frames_batch`` draw from numpy's PCG64 seeded with
(seed, step, shard); the other four from a ``torch.Generator`` seeded by
a hash of (seed, step, shard), their fixed parts (teacher, anchors,
frequencies, patterns) from one seeded by the seed alone, as the
reference keeps them fixed across steps. The reference draws from JAX's
threefry, so the two packages give other values under the same rules
(the parity tests feed both one batch).
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, Tuple

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


def _generator(*key) -> torch.Generator:
    """A CPU generator seeded by a hash of ``key`` (ints)."""
    digest = hashlib.md5(repr(tuple(int(k) for k in key)).encode()).digest()
    gen = torch.Generator()
    gen.manual_seed(int.from_bytes(digest[:8], "little") & (2**63 - 1))
    return gen


def teacher_weights(seed: int, dim: int, classes: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fixed teacher of ``teacher_mlp``: w1 (dim, 64), w2 (64, classes)."""
    gen = _generator(seed, 7777)
    return (torch.randn((dim, 64), generator=gen),
            torch.randn((64, classes), generator=gen))


def teacher_mlp(seed: int, step: int, batch: int, dim: int, classes: int,
                shard: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """A fixed random teacher labels random inputs: x (batch, dim) N(0, 1),
    y = argmax(tanh(x @ w1) @ w2) (int64)."""
    w1, w2 = teacher_weights(seed, dim, classes)
    x = torch.randn((batch, dim), generator=_generator(seed, step, shard))
    return x, torch.argmax(torch.tanh(x @ w1) @ w2, dim=-1)


def cloud_anchors(seed: int, classes: int) -> torch.Tensor:
    """The fixed anchor layouts of ``point_cloud``: (classes, 8, 3)."""
    return torch.randn((classes, 8, 3), generator=_generator(seed, 4242)) * 2.0


def point_cloud(seed: int, step: int, batch: int, n_points: int, classes: int,
                shard: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class = which of ``classes`` fixed anchor layouts generated the cloud:
    each point is one of its layout's 8 anchors plus 0.1 * N(0, 1).
    Returns points (batch, n_points, 3) and labels (batch,) int64."""
    anchors = cloud_anchors(seed, classes)
    gen = _generator(seed, step, shard)
    labels = torch.randint(0, classes, (batch,), generator=gen)
    idx = torch.randint(0, 8, (batch, n_points), generator=gen)
    centers = torch.gather(anchors[labels], 1, idx[..., None].expand(-1, -1, 3))
    pts = centers + 0.1 * torch.randn((batch, n_points, 3), generator=gen)
    return pts, labels


def sine_params(seed: int, features: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fixed (features, 3) frequencies in [0.02, 0.3) and amplitudes in
    [0, 1) of ``sine_mixture``."""
    gen = _generator(seed, 99)
    freqs = 0.02 + 0.28 * torch.rand((features, 3), generator=gen)
    return freqs, torch.rand((features, 3), generator=gen)


def sine_mixture(seed: int, step: int, batch: int, length: int, features: int,
                 shard: int = 0) -> torch.Tensor:
    """Multivariate series: each feature a sum of 3 fixed sines with a
    random phase per row, plus 0.05 * N(0, 1) noise. Returns (batch,
    length, features) f32."""
    freqs, amps = sine_params(seed, features)
    gen = _generator(seed, step, shard)
    phase = 2 * math.pi * torch.rand((batch, features, 3), generator=gen)
    t = torch.arange(length, dtype=torch.float32)
    sig = (amps[None, :, :, None]
           * torch.sin(freqs[None, :, :, None] * t + phase[..., None])).sum(dim=2)
    noise = 0.05 * torch.randn(sig.shape, generator=gen)
    return (sig + noise).movedim(1, 2)


def image_patterns(seed: int, res: int, classes: int) -> torch.Tensor:
    """The fixed class textures of ``image_like``: (classes, res, res, 3)."""
    return torch.randn((classes, res, res, 3), generator=_generator(seed, 31337))


def image_like(seed: int, step: int, batch: int, res: int, classes: int,
               shard: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """NHWC images: the label's texture plus 0.5 * N(0, 1). Returns x
    (batch, res, res, 3) and labels (batch,) int64."""
    patterns = image_patterns(seed, res, classes)
    gen = _generator(seed, step, shard)
    labels = torch.randint(0, classes, (batch,), generator=gen)
    x = patterns[labels] + 0.5 * torch.randn((batch, res, res, 3), generator=gen)
    return x, labels
