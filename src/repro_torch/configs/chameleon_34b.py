"""chameleon-34b — early-fusion VLM decoder with VQ image tokens.

[arXiv:2405.09818] 48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536,
QK-norm. Early fusion: image positions carry precomputed patch/VQ
embeddings (``image_mask`` / ``image_embeds`` in the batch; the modality
frontend is a stub); text positions use the shared 65536-entry table.
Heads-sharded attention (64H divides); ``grad_accum`` x2 for the
8192-wide residual stream.
"""
from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import tbn_policy

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    d_ff=22_016,
    vocab=65_536,
    qk_norm=True,
    attn_act="heads",
    grad_accum=2,                   # microbatch x2 for the 8192-wide stream
    activation="silu",
    gated_mlp=True,
    norm="rmsnorm",
    modality="vlm",
    tbn=tbn_policy(p=8, min_size=150_000, alpha_source="W", alpha_mode="tile"),
)
