"""qwen1.5-32b — large dense decoder with QKV bias and an int8 KV cache.

[hf:Qwen family] 64L d_model=5120 40H (GQA kv=40) d_ff=27392 vocab=152064.
The reference's mesh-only field (sequence-sharded attention) comes with
the distributed slice; ``grad_accum`` and the int8 KV cache stay.
"""
from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import tbn_policy

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv=40,
    d_ff=27_392,
    vocab=152_064,
    qkv_bias=True,
    grad_accum=2,
    kv_dtype="int8",
    activation="silu",
    gated_mlp=True,
    norm="rmsnorm",
    tbn=tbn_policy(p=8, min_size=150_000, alpha_source="W", alpha_mode="tile"),
)
