"""granite-8b — IBM Granite code model, llama-style dense decoder.

[arXiv:2405.04324] 36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152.
"""
from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import tbn_policy

CONFIG = ArchConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_ff=14_336,
    vocab=49_152,
    activation="silu",
    gated_mlp=True,
    norm="rmsnorm",
    tbn=tbn_policy(p=8, min_size=150_000, alpha_source="W", alpha_mode="tile"),
)
