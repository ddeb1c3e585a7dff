"""Gradient clipping (port of ``repro/optim/clip.py``)."""
from __future__ import annotations

import torch

from repro_torch.nn import module as mod


def global_norm(tree) -> torch.Tensor:
    """sqrt(sum of squares) over every leaf, in float32."""
    return torch.sqrt(sum(x.float().square().sum() for _, x in mod.walk(tree)))


@torch.no_grad()
def clip_by_global_norm(tree, max_norm: float):
    """-> (tree scaled by min(1, max_norm / (norm + 1e-9)), norm). The
    leaves are scaled in place (no second copy of the gradients); the norm
    stays on the device, so clipping never waits for it."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for _, x in mod.walk(tree):
        x.copy_(x.float() * scale)
    return tree, norm
