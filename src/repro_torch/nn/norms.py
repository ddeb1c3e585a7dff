"""Normalization layers, never quantized (port of ``repro/nn/norms.py``).
Reductions in f32; the elementwise apply stays in the input dtype, as in
the reference."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.ordered import ordered_mean
from repro_torch.nn import module as mod
from repro_torch.nn.context import ModelContext


@dataclasses.dataclass
class RMSNorm:
    dim: int
    ctx: ModelContext
    name: str = "rmsnorm"
    eps: float = 1e-6

    def specs(self) -> mod.SpecTree:
        return {"scale": mod.ParamSpec((self.dim,), torch.float32, ("embed",),
                                       mod.ones_init())}

    def __call__(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        var = x.float().square().mean(dim=-1, keepdim=True)
        inv = torch.rsqrt(var + self.eps).to(dt)
        return x * inv * params["scale"].to(dt)


# kept under its old name for the callers that import it from here
_ordered_mean = ordered_mean


@dataclasses.dataclass
class LayerNorm:
    dim: int
    ctx: ModelContext
    name: str = "layernorm"
    eps: float = 1e-5

    def specs(self) -> mod.SpecTree:
        return {
            "scale": mod.ParamSpec((self.dim,), torch.float32, ("embed",),
                                   mod.ones_init()),
            "bias": mod.ParamSpec((self.dim,), torch.float32, ("embed",),
                                  mod.zeros_init()),
        }

    def __call__(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """On the CPU the mean is summed in the reference's order
        (``core.ordered.ordered_mean``, bit for bit ``jnp.mean`` at any
        width): under the integer compute paths a row of quantized products
        can have elements equal to its mean, and x - mu is then a rounding
        error whose sign the next layer's sign or int8 quantization keeps.
        The variance, the rsqrt and the apply are PyTorch's (ROADMAP C1
        says what rounding that leaves against the reference). On the card
        the kernels' sums differ from the reference's anyway, and the mean
        is one reduction."""
        dt = x.dtype
        xf = x.float()
        if x.device.type == "cpu":
            mu = ordered_mean(xf)
        else:
            mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (x - mu.to(dt)) * torch.rsqrt(var + self.eps).to(dt)
        return y * params["scale"].to(dt) + params["bias"].to(dt)
