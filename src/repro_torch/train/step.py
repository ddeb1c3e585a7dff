"""Train-step builder: loss -> grads -> (optional transform) -> clip ->
optimizer, with microbatch gradient accumulation (port of
``repro/train/step.py``).

The returned step is a function (TrainState, batch) -> (TrainState,
metrics). Remat and the layer loop live inside the model; this layer adds
accumulation and the update rule. The optimizer updates the params in
place (see ``optim.adamw``), so the returned state holds the same param
tensors. Metrics stay on the device: reading them waits for the step.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.nn import module as mod
from repro_torch.optim import clip_by_global_norm
from repro_torch.optim.adamw import Optimizer


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: int


def init_state(params, optimizer: Optimizer) -> TrainState:
    return TrainState(params=params, opt_state=optimizer.init(params), step=0)


def _split(batch: Dict, n: int):
    """Cut every tensor of ``batch`` into n microbatches along axis 0."""
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows, not "
                             f"divisible by grad_accum={n}")
    return [{k: v.chunk(n)[i] for k, v in batch.items()} for i in range(n)]


def build_train_step(
    loss_fn: Callable[[Any, Dict], Tuple[torch.Tensor, Dict]],
    optimizer: Optimizer,
    *,
    grad_accum: int = 1,
    clip_norm: Optional[float] = 1.0,
    grad_transform: Optional[Callable] = None,   # e.g. compressed DP allreduce
):
    def value_and_grad(params, batch):
        paths, leaves = zip(*mod.walk(params))
        for v in leaves:
            if not v.requires_grad:
                v.requires_grad_(True)
        loss, aux = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        tree: dict = {}
        for path, g in zip(paths, grads):
            mod.set_path(tree, path, g)
        return loss.detach(), mod.map_tree(torch.Tensor.detach, aux), tree

    def microbatched_grads(params, batch):
        if grad_accum <= 1:
            return value_and_grad(params, batch)
        gsum, loss_sum = None, 0.0
        for mb in _split(batch, grad_accum):
            loss, aux, grads = value_and_grad(params, mb)
            loss_sum = loss_sum + loss
            if gsum is None:
                gsum = mod.map_tree(lambda g: g.float(), grads)
            else:
                for path, g in mod.walk(grads):
                    mod.set_path(gsum, path, mod.get_path(gsum, path) + g.float())
        grads = mod.map_tree(lambda g: g / grad_accum, gsum)
        return loss_sum / grad_accum, aux, grads      # aux of the last microbatch

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        loss, aux, grads = microbatched_grads(state.params, batch)
        if grad_transform is not None:
            grads = grad_transform(grads)
        gnorm = torch.zeros((), device=loss.device)
        if clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
        new_params, new_opt = optimizer.update(grads, state.opt_state, state.params)
        metrics = {"loss": loss, "grad_norm": gnorm, **aux}
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step
