"""qwen2-moe-a2.7b — Qwen1.5-MoE-A2.7B: 4 shared + 60 routed top-4.

[hf:Qwen/Qwen1.5-MoE-A2.7B] 24L d_model=2048 16H (GQA kv=16) expert
d_ff=1408 vocab=151936. Shared expert intermediate = 5632 = 4 x 1408
(modeled as n_shared=4 units). Qwen uses QKV bias.
"""
from repro_torch.configs.base import ArchConfig, MoESpec
from repro_torch.core.policy import tbn_policy

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    d_ff=1408,
    vocab=151_936,
    moe=MoESpec(n_experts=60, top_k=4, n_shared=4, d_ff_expert=1408),
    qkv_bias=True,
    activation="silu",
    gated_mlp=True,
    norm="rmsnorm",
    tbn=tbn_policy(p=8, min_size=150_000, alpha_source="W", alpha_mode="tile"),
)
