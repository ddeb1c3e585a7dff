"""mamba2-370m — attention-free SSD (state-space duality).

[arXiv:2405.21060] 48L d_model=1024, ssm_state=128, vocab=50280.
O(1) decode state per slot: an (h, conv) carry, no K/V cache.
"""
from repro_torch.configs.base import ArchConfig, SSMSpec
from repro_torch.core.policy import tbn_policy

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv=0,
    d_ff=0,
    vocab=50_280,
    ssm=SSMSpec(d_state=128, head_dim=64, expand=2, n_groups=1, chunk=256),
    norm="rmsnorm",
    subquadratic=True,
    tbn=tbn_policy(p=4, min_size=150_000, alpha_source="W", alpha_mode="tile"),
)
