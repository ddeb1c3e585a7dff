"""seamless-m4t-large-v2 — encoder-decoder multimodal backbone.

[arXiv:2308.11596] 24L d_model=1024 16H (kv=16) d_ff=8192 vocab=256206.
Backbone only: the speech frontend is a stub, and requests carry
precomputed frame embeddings (S, d_model). 24 encoder + 24 decoder
layers; decoder text length = seq_len // dec_ratio in training.
"""
from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import tbn_policy

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=48,                    # 24 enc + 24 dec
    enc_layers=24,
    dec_layers=24,
    dec_ratio=4,
    d_model=1024,
    n_heads=16,
    n_kv=16,
    d_ff=8192,
    vocab=256_206,
    activation="relu",
    gated_mlp=False,
    norm="layernorm",
    rope_theta=0.0,                 # learned/sinusoidal family; no rope
    modality="audio",
    tbn=tbn_policy(p=4, min_size=150_000, alpha_source="W", alpha_mode="tile"),
)
