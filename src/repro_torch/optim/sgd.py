"""SGD + momentum + weight decay, the paper's CNN recipe (port of
``repro/optim/sgd.py``). Params and momentum are updated in place, as in
``adamw``."""
from __future__ import annotations

from typing import Callable, NamedTuple, Union

import torch

from repro_torch.nn import module as mod
from repro_torch.optim.adamw import Optimizer, zeros_like_f32


class SGDState(NamedTuple):
    step: int
    momentum: dict


def sgd_momentum(lr: Union[Callable[[int], float], float], momentum: float = 0.9,
                 weight_decay: float = 0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: float(lr))

    def init(params) -> SGDState:
        return SGDState(step=0, momentum=zeros_like_f32(params))

    @torch.no_grad()
    def update(grads, state: SGDState, params):
        step = state.step + 1
        lr_t = lr_fn(step)
        for path, p in mod.walk(params):
            g = mod.get_path(grads, path).float()
            if weight_decay:
                g = g + weight_decay * p.float()
            m = mod.get_path(state.momentum, path)
            m.mul_(momentum).add_(g)
            p.copy_(p.float() - lr_t * m)
        return params, SGDState(step=step, momentum=state.momentum)

    return Optimizer(init=init, update=update)
