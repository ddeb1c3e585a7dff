"""minitron-8b — pruned Nemotron-4: squared-ReLU MLP, 256k vocab.

[arXiv:2407.14679] 32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
"""
from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import tbn_policy

CONFIG = ArchConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_ff=16_384,
    vocab=256_000,
    activation="relu2",
    gated_mlp=False,
    norm="layernorm",
    tbn=tbn_policy(p=8, min_size=150_000, alpha_source="W", alpha_mode="tile"),
)
