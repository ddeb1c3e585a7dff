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
        return {"scale": mod.ParamSpec((self.dim,), torch.float32, ("embed",),
                                       mod.ones_init())}

    def __call__(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        var = x.float().square().mean(dim=-1, keepdim=True)
        inv = torch.rsqrt(var + self.eps).to(dt)
        return x * inv * params["scale"].to(dt)


# XLA's CPU backend splits a long f32 reduction into windows of this many
# elements, each summed in order, then reduces the windows' partials the
# same way (its tree-reduction rewrite)
XLA_REDUCE_WINDOW = 32


def _ordered_mean(xf: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis (length a multiple of ``XLA_REDUCE_WINDOW``)
    in the reference's f32 summation order on the CPU: sequential sums
    over windows of 32, then over the partials, recursively."""
    n, part = xf.shape[-1], xf
    while part.shape[-1] > XLA_REDUCE_WINDOW:
        w = part.unflatten(-1, (-1, XLA_REDUCE_WINDOW))
        acc = w[..., 0]
        for i in range(1, XLA_REDUCE_WINDOW):
            acc = acc + w[..., i]
        part = acc
    acc = part[..., :1]
    for i in range(1, part.shape[-1]):
        acc = acc + part[..., i:i + 1]
    return acc / n


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
        (``_ordered_mean``) where the width is a multiple of 32: under the
        integer compute paths a row of quantized products can have
        elements equal to its mean, and x - mu is then a rounding error
        whose sign the next layer's sign or int8 quantization keeps. On
        the card the kernels' sums differ from the reference's anyway, and
        the mean is one reduction."""
        dt = x.dtype
        xf = x.float()
        if x.device.type == "cpu" and xf.shape[-1] % XLA_REDUCE_WINDOW == 0:
            mu = _ordered_mean(xf)
        else:
            mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (x - mu.to(dt)) * torch.rsqrt(var + self.eps).to(dt)
        return y * params["scale"].to(dt) + params["bias"].to(dt)
