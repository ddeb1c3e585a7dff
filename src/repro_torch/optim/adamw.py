"""AdamW over a param tree (port of ``repro/optim/adamw.py``): b2 = 0.95
by default, float32 moments, weight decay added to the update of every
leaf, ``lr(step)`` read at the 1-based step.

The reference returns new params and moments; here the update writes the
params and moments in place (one copy of each on the device, not two) and
returns the same tree objects with the new step count."""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Union

import torch

from repro_torch.nn import module as mod


class AdamWState(NamedTuple):
    step: int
    mu: dict
    nu: dict


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def zeros_like_f32(params) -> dict:
    return mod.map_tree(lambda p: torch.zeros_like(p, dtype=torch.float32,
                                                   requires_grad=False), params)


def adamw(lr: Union[Callable[[int], float], float], b1: float = 0.9,
          b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.0
          ) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: float(lr))

    def init(params) -> AdamWState:
        return AdamWState(step=0, mu=zeros_like_f32(params),
                          nu=zeros_like_f32(params))

    @torch.no_grad()
    def update(grads, state: AdamWState, params):
        step = state.step + 1
        lr_t = lr_fn(step)
        bc1 = 1.0 - b1 ** step
        bc2 = 1.0 - b2 ** step
        for path, p in mod.walk(params):
            g = mod.get_path(grads, path).float()
            m, v = mod.get_path(state.mu, path), mod.get_path(state.nu, path)
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                delta = delta + weight_decay * p.float()
            p.copy_(p.float() - lr_t * delta)
        return params, AdamWState(step=step, mu=state.mu, nu=state.nu)

    return Optimizer(init=init, update=update)
