"""Normalization layers, never quantized (port of ``repro/nn/norms.py``).
Reductions in f32; the elementwise apply stays in the input dtype, as in
the reference."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.nn import module as mod
from repro_torch.nn.context import ModelContext


@dataclasses.dataclass
class RMSNorm:
    dim: int
    ctx: ModelContext
    name: str = "rmsnorm"
    eps: float = 1e-6

    def specs(self) -> mod.SpecTree:
        return {"scale": mod.ParamSpec((self.dim,), torch.float32, mod.ones_init())}

    def __call__(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        var = x.float().square().mean(dim=-1, keepdim=True)
        inv = torch.rsqrt(var + self.eps).to(dt)
        return x * inv * params["scale"].to(dt)


@dataclasses.dataclass
class LayerNorm:
    dim: int
    ctx: ModelContext
    name: str = "layernorm"
    eps: float = 1e-5

    def specs(self) -> mod.SpecTree:
        return {
            "scale": mod.ParamSpec((self.dim,), torch.float32, mod.ones_init()),
            "bias": mod.ParamSpec((self.dim,), torch.float32, mod.zeros_init()),
        }

    def __call__(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (x - mu.to(dt)) * torch.rsqrt(var + self.eps).to(dt)
        return y * params["scale"].to(dt) + params["bias"].to(dt)
