"""starcoder2-7b — GQA + RoPE code model, GELU MLP, LayerNorm.

[arXiv:2402.19173] 32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.
The reference's mesh-only fields (sequence-sharded attention, ZeRO-3
weight gathering) come with the distributed slice; ``grad_accum`` stays.
"""
from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import tbn_policy

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv=4,
    d_ff=18_432,
    vocab=49_152,
    activation="gelu",
    gated_mlp=False,
    norm="layernorm",
    qkv_bias=True,
    grad_accum=2,
    tbn=tbn_policy(p=8, min_size=150_000, alpha_source="W", alpha_mode="tile"),
)
