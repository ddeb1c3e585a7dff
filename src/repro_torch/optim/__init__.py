"""Optimizers, schedules and clipping (port of ``repro/optim``)."""
from repro_torch.optim.adamw import adamw
from repro_torch.optim.clip import clip_by_global_norm
from repro_torch.optim.schedule import constant, cosine_with_warmup
from repro_torch.optim.sgd import sgd_momentum

__all__ = [
    "adamw",
    "sgd_momentum",
    "constant",
    "cosine_with_warmup",
    "clip_by_global_norm",
]
