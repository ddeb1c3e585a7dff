"""recurrentgemma-2b — Griffin hybrid: RG-LRU + local attention, 1:2.

[arXiv:2402.19427] 26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000,
sliding window 2048, block cycle (rec, rec, attn): 8 cycles, then two
``rec`` tails. Decode state per slot: RG-LRU carries and a bounded
window ring.
"""
from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import tbn_policy

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv=1,
    d_ff=7680,
    vocab=256_000,
    pattern=("rec", "rec", "attn"),
    window=2048,
    activation="gelu",
    gated_mlp=True,
    norm="rmsnorm",
    tbn=tbn_policy(p=8, min_size=150_000, alpha_source="W", alpha_mode="tile"),
)
