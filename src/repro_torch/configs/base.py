"""Architecture config schema and input-shape cells (port of
``repro/configs/base.py``: the model and training fields, the shape-cell
capabilities, ``fsdp_weights`` and ``rules_override``; the ``attn_act``
recipe is not ported)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

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
    # shape-cell capabilities
    supports_decode: bool = True
    subquadratic: bool = False     # may run long_500k
    remat: str = "full"            # training: full | dots | none
    attn_chunk: int = 1024         # chunked-attention query block
    grad_accum: int = 1            # microbatches per training step
    # the reference's roofline unrolls its layer scan with this; the port's
    # layer loop is always unrolled, so it changes nothing here
    force_unroll: bool = False
    # training under a mesh: a tiled Dense's masters also split their n_in
    # dim over "data" and are gathered at use (ZeRO-3)
    fsdp_weights: bool = False
    # per-arch logical -> mesh rule overrides ((key, value) pairs merged over
    # distributed.sharding.DEFAULT_RULES)
    rules_override: Tuple[Tuple[str, object], ...] = ()

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


# ---------------------------------------------------------------------------
# Input-shape cells (shared by all LM-family archs)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


def cell_applicable(cfg: ArchConfig, shape: ShapeCell) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped), the reference's skips word for word."""
    if shape.kind == "decode" and not cfg.supports_decode:
        return False, "SKIP: encoder-only, no decode step"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "SKIP: full-attention (needs sub-quadratic)"
    return True, ""
