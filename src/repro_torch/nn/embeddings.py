"""Token embeddings + tied logits head, untiled per paper scope (port of
``repro/nn/embeddings.py``)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.distributed.sharding import slots_matmul
from repro_torch.nn import module as mod
from repro_torch.nn.context import ModelContext


@dataclasses.dataclass
class Embedding:
    vocab: int
    dim: int
    ctx: ModelContext
    name: str = "embed"

    def __post_init__(self):
        self.ctx.note(self.name, (self.vocab, self.dim), kind="embedding", spec=None)

    def specs(self) -> mod.SpecTree:
        return {"table": mod.ParamSpec((self.vocab, self.dim),
                                       self.ctx.param_dtype, ("vocab", "embed"),
                                       mod.normal(0.02))}

    def __call__(self, params: dict, ids: torch.Tensor) -> torch.Tensor:
        # Gather first, then cast: the same values as the reference's
        # cast-then-gather, without converting the whole (vocab, d) table
        # on every call.
        return params["table"][ids].to(self.ctx.compute_dtype)

    def attend(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """Tied logits head: x @ table^T (over every slot's rows under a slot
        split, ``sharding.slots_matmul``)."""
        return slots_matmul(x, params["table"].to(self.ctx.compute_dtype).T)
