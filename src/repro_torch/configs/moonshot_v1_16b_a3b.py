"""moonshot-v1-16b-a3b — Moonlight/Kimi MoE, 64 routed experts top-6.

[hf:moonshotai/Moonlight-16B-A3B] 48L d_model=2048 16H (GQA kv=16)
expert d_ff=1408, vocab=163840. DeepSeek-V3-style extras from the HF config:
2 shared experts, first layer dense FFN. GQA kv=16 (not MLA) and the int8
K/V cache are pinned as the reference pins them.
"""
from repro_torch.configs.base import ArchConfig, MoESpec
from repro_torch.core.policy import tbn_policy

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    d_ff=1408,                      # expert/shared unit width
    vocab=163_840,
    moe=MoESpec(n_experts=64, top_k=6, n_shared=2, d_ff_expert=1408,
                first_dense=True),
    activation="silu",
    gated_mlp=True,
    norm="rmsnorm",
    kv_dtype="int8",            # 47-layer 32k x 128 cache, halved
    tbn=tbn_policy(p=8, min_size=150_000, alpha_source="W", alpha_mode="tile"),
)
