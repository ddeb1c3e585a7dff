"""Token sampling: greedy / temperature / top-k (port of
``repro/serve/sampling.py``).

``sample_logits_batch`` samples each row with its own temperature, top-k
and seed, as the engine's ticks need; ``sample_logits`` is the scalar form
for single-stream callers: one temperature, one top-k and one seed for the
whole batch.

Greedy is ``argmax`` and matches the reference token for token. A
stochastic row draws its Gumbel noise from a ``torch.Generator`` seeded
from (its request's key stream, token index), so a request's tokens never
depend on its batch neighbours or on scheduling. JAX's threefry PRNG is
not ported: stochastic tokens are reproducible within the port, not equal
to the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: Optional[float] = None  # None -> engine default; 0 -> greedy
    top_k: Optional[int] = None          # None -> engine default; 0 -> off
    max_tokens: int = 64
    eos_id: int = -1                     # -1 -> never stops on a token
    seed: Optional[int] = None           # explicit per-request stream seed
    priority: Optional[str] = None       # scheduling class ("interactive" |
    # "batch"; engine.PRIORITY_RANKS) or None for ServeConfig.default_priority.
    # It orders admission and picks preemption victims and never touches
    # sampling: a request's tokens are the same at any priority

    def resolve(self, default_temperature: float,
                default_top_k: Optional[int]) -> "ResolvedSampling":
        """Fill ``None`` sentinels from the engine defaults (explicit falsy
        values like 0.0 / 0 are kept)."""
        t = self.temperature if self.temperature is not None else default_temperature
        k = self.top_k if self.top_k is not None else default_top_k
        return ResolvedSampling(
            temperature=float(t), top_k=int(k) if k is not None else 0,
            eos_id=int(self.eos_id),
            seed=int(self.seed) if self.seed is not None else None,
            priority=self.priority)

    # ---- HTTP handoff -------------------------------------------------
    _JSON_FIELDS = ("temperature", "top_k", "max_tokens", "eos_id", "seed",
                    "priority")

    @classmethod
    def from_json(cls, body: dict) -> "SamplingParams":
        """Build params from a decoded request body. Keys that are not
        sampling fields (``prompt``, ``stream``, ...) are ignored, and only
        the documented field names bind: a misspelt field is not guessed
        at."""
        kw = {}
        for f in cls._JSON_FIELDS:
            if body.get(f) is not None:
                kw[f] = body[f]
        if "temperature" in kw:
            kw["temperature"] = float(kw["temperature"])
        for f in ("top_k", "max_tokens", "eos_id", "seed"):
            if f in kw:
                kw[f] = int(kw[f])
        if "priority" in kw:
            kw["priority"] = str(kw["priority"])
        return cls(**kw)

    def to_json(self) -> dict:
        """The inverse handoff (client helpers, replays): only the fields
        that differ from the defaults, so a replayed request is exactly the
        submitted one."""
        out = {}
        for f in self._JSON_FIELDS:
            v = getattr(self, f)
            if v is not None and v != getattr(type(self)(), f):
                out[f] = v
        return out


@dataclasses.dataclass(frozen=True)
class ResolvedSampling:
    temperature: float
    top_k: int
    eos_id: int
    seed: Optional[int] = None
    priority: Optional[str] = None       # as given: the engine resolves it


def row_seed(stream: Tuple[int, ...], t: int) -> int:
    """Generator seed for token ``t`` of the request key stream ``stream``:
    (engine seed, rid), or (explicit request seed,)."""
    state = np.random.SeedSequence([*stream, t]).generate_state(1, np.uint64)
    return int(state[0]) & (2**63 - 1)


def sample_logits_batch(logits: torch.Tensor, temperature: Sequence[float],
                        top_k: Sequence[int], seeds: Sequence[Optional[int]]
                        ) -> torch.Tensor:
    """logits (B, V) -> token ids (B,) int64 on logits' device.

    Row i is greedy when temperature[i] <= 0; otherwise it samples
    softmax(logits / T) restricted to the top_k[i] largest logits (0 or >= V
    restricts nothing) with the Gumbel-max trick, drawing its noise from a
    generator seeded with seeds[i] alone."""
    lf = logits.float()
    out = lf.argmax(dim=-1)
    v = lf.shape[-1]
    for i, t in enumerate(temperature):
        if t <= 0.0:
            continue
        row = lf[i] / t
        k = int(top_k[i])
        if 0 < k < v:
            kth = torch.topk(row, k).values[-1]
            row = torch.where(row < kth, float("-inf"), row)
        gen = torch.Generator(device=lf.device)
        gen.manual_seed(seeds[i])
        u = torch.rand(v, generator=gen, device=lf.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
        out[i] = (row + gumbel).argmax()
    return out


def sample_logits(logits: torch.Tensor, seed: int = 0, *,
                  temperature: float = 0.0,
                  top_k: Optional[int] = None) -> torch.Tensor:
    """logits (B, V) -> token ids (B,) int64 under one sampler config for
    every row. Greedy (``temperature <= 0``) is ``argmax``; otherwise row i
    draws its noise from ``row_seed((seed,), i)``, so rows are independent
    and the call is reproducible from ``seed``."""
    b = logits.shape[0]
    return sample_logits_batch(
        logits, [float(temperature)] * b, [int(top_k or 0)] * b,
        [row_seed((int(seed),), i) for i in range(b)])
