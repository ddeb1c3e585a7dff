"""Architecture config schema (port of the model and training fields of
``repro/configs/base.py``, with ``fsdp_weights``). The other sharding
recipes and the shape cells are not ported."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.policy import TBNPolicy, tbn_policy


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    n_shared: int = 0
    d_ff_expert: int = 0
    first_dense: bool = False      # moonlight/deepseek: layer 0 dense FFN


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    moe: Optional[MoESpec] = None
    ssm: Optional[SSMSpec] = None
    pattern: Tuple[str, ...] = ()  # hybrid block cycle, e.g. ("rec","rec","attn")
    window: Optional[int] = None   # sliding-window attention size
    qkv_bias: bool = False
    qk_norm: bool = False
    activation: str = "silu"
    gated_mlp: bool = True
    norm: str = "rmsnorm"
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    # enc-dec
    enc_layers: int = 0
    dec_layers: int = 0
    dec_ratio: int = 4             # dec tokens = seq_len // dec_ratio (audio)
    modality: str = "text"         # text | audio | vlm
    tbn: TBNPolicy = dataclasses.field(
        default_factory=lambda: tbn_policy(
            p=4, min_size=150_000, alpha_source="W", alpha_mode="tile"
        )
    )
    kv_dtype: str = "bf16"         # "bf16" (the compute dtype) | "int8"
    remat: str = "full"            # training: full | none ("dots" not ported)
    attn_chunk: int = 1024         # chunked-attention query block
    grad_accum: int = 1            # microbatches per training step
    # training under a mesh: a tiled Dense's masters also split their n_in
    # dim over "data" and are gathered at use (ZeRO-3)
    fsdp_weights: bool = False

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests (the reference's
        ``reduced()``)."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers,
                         2 if not self.pattern else len(self.pattern)),
            d_model=min(self.d_model, 64),
            n_heads=min(self.n_heads, 4),
            n_kv=min(self.n_kv, 2),
            head_dim=16,
            d_ff=min(self.d_ff, 128),
            vocab=min(self.vocab, 512),
            moe=None
            if self.moe is None
            else dataclasses.replace(
                self.moe,
                n_experts=min(self.moe.n_experts, 8),
                top_k=min(self.moe.top_k, 2),
                n_shared=min(self.moe.n_shared, 1),
                d_ff_expert=min(self.moe.d_ff_expert or 64, 64),
            ),
            ssm=None
            if self.ssm is None
            else dataclasses.replace(self.ssm, d_state=16, head_dim=16, chunk=8),
            enc_layers=min(self.enc_layers, 2),
            dec_layers=min(self.dec_layers, 2),
            window=None if self.window is None else min(self.window, 8),
            tbn=dataclasses.replace(self.tbn, min_size=1024),
            attn_chunk=64,
        )
