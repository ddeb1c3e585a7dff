"""Architecture config schema (port of the dense-family fields of
``repro/configs/base.py``). Families other than ``dense`` and the fields
only they read (MoE, SSM, hybrid pattern, enc-dec, sharding recipes) come
with the slices that port those families."""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.policy import TBNPolicy, tbn_policy


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # only "dense" builds in this port so far
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    window: Optional[int] = None   # sliding-window attention (not ported)
    qkv_bias: bool = False
    qk_norm: bool = False
    activation: str = "silu"
    gated_mlp: bool = True
    norm: str = "rmsnorm"
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    tbn: TBNPolicy = dataclasses.field(
        default_factory=lambda: tbn_policy(
            p=4, min_size=150_000, alpha_source="W", alpha_mode="tile"
        )
    )
    kv_dtype: str = "bf16"         # "int8" KV waits for a later slice

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests (the reference's
        ``reduced()`` for the dense family)."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 2),
            d_model=min(self.d_model, 64),
            n_heads=min(self.n_heads, 4),
            n_kv=min(self.n_kv, 2),
            head_dim=16,
            d_ff=min(self.d_ff, 128),
            vocab=min(self.vocab, 512),
            window=None if self.window is None else min(self.window, 8),
            tbn=dataclasses.replace(self.tbn, min_size=1024),
        )
