"""Feed-forward block, gated (SwiGLU) or not (port of ``MLP`` in
``repro/nn/ffn.py``)."""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.nn import module as mod
from repro_torch.nn.context import ModelContext
from repro_torch.nn.linear import Dense

ACTIVATIONS = {
    "silu": F.silu,
    "gelu": lambda v: F.gelu(v, approximate="tanh"),  # jax.nn.gelu default
    "relu": F.relu,
    "relu2": lambda v: F.relu(v).square(),
}


@dataclasses.dataclass
class MLP:
    """up -> act -> down; gated (SwiGLU) when ``gated=True``."""

    d_model: int
    d_ff: int
    ctx: ModelContext
    name: str = "mlp"
    gated: bool = True
    activation: str = "silu"

    def __post_init__(self):
        c = self.ctx
        self.up = Dense(self.d_model, self.d_ff, c, name=f"{self.name}.up",
                        logical=("mlp", "embed"))
        if self.gated:
            self.gate = Dense(self.d_model, self.d_ff, c, name=f"{self.name}.gate",
                              logical=("mlp", "embed"))
        self.down = Dense(self.d_ff, self.d_model, c, name=f"{self.name}.down",
                          logical=("embed", "mlp"))
        self._act = ACTIVATIONS[self.activation]

    def specs(self) -> mod.SpecTree:
        out = {"up": self.up.specs(), "down": self.down.specs()}
        if self.gated:
            out["gate"] = self.gate.specs()
        return out

    def __call__(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        h = self.up(params["up"], x)
        if self.gated:
            h = self._act(self.gate(params["gate"], x)) * h
        else:
            h = self._act(h)
        return self.down(params["down"], h)
