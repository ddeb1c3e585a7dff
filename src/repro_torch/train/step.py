"""Train-step builder: loss -> grads -> (optional transform) -> clip ->
optimizer, with microbatch gradient accumulation (port of
``repro/train/step.py``).

The returned step is a function (TrainState, batch) -> (TrainState,
metrics). Remat and the layer loop live inside the model; this layer adds
accumulation, the update rule and, under a mesh, the data-parallel
reduction. The optimizer updates the params in
place (see ``optim.adamw``), so the returned state holds the same param
tensors. Metrics stay on the device: reading them waits for the step.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.distributed.sharding import (
    axis_rules,
    mesh_extents,
    shard_index,
    sum_over,
)
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


def _dp_axes(mesh, axis) -> Tuple[str, ...]:
    """The data-parallel axes (a name or a tuple of names, row-major) that
    the mesh has."""
    names = mesh_extents(mesh)
    return tuple(a for a in ((axis,) if isinstance(axis, str) else axis)
                 if a in names)


def dp_rows(batch: Dict, mesh, grad_accum: int = 1, axis="data") -> Dict:
    """This rank's rows of the global ``batch`` over the mesh's ``axis``
    (or axes, row-major), in the order the reference's microbatches take
    them: global microbatch i (rows [i B/n, (i+1) B/n) of n =
    ``grad_accum``) gives rank d its d-th block, so the rank's microbatch i
    is its block of the reference's microbatch i."""
    axes = _dp_axes(mesh, axis)
    ext = mesh_extents(mesh)
    dp = 1
    for a in axes:
        dp *= ext[a]
    if dp == 1:
        return batch
    d = shard_index(mesh, axes)
    out = {}
    for k, v in batch.items():
        if v.shape[0] % (grad_accum * dp):
            raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows, not "
                             f"divisible by grad_accum={grad_accum} x {axis}={dp}")
        blocks = v.reshape(grad_accum, dp, v.shape[0] // (grad_accum * dp),
                           *v.shape[1:])
        out[k] = blocks[:, d].reshape(-1, *v.shape[1:])
    return out


def _mesh_grads(grads, loss, mesh, shards, axis="data", reduce=None):
    """The one-device step's loss and gradients from a rank's: the loss and
    every gradient averaged over ``axis`` (or axes; an FSDP leaf's gradient
    came back summed over its cols axes from its gather's reduce-scatter;
    every other axis is all_reduced here). Leaves split over "model" keep
    their rows. ``reduce`` (a codec's mean over ``axis``, as
    ``distributed.compression``'s ``CompressedMean``) takes the exact
    mean's place for the gradients."""
    axes = _dp_axes(mesh, axis)
    ext = mesh_extents(mesh)
    dp = 1
    for a in axes:
        dp *= ext[a]
    if reduce is not None:
        grads = reduce(grads)
    elif dp > 1:
        for path, g in mod.walk(grads):
            shard = mod.get_path(shards, path) if shards is not None else None
            done = () if shard is None else shard.cols
            rest = tuple(a for a in axes if a not in done)
            if rest:
                g.copy_(sum_over(g, mesh, rest))
            g.div_(dp)
    if dp == 1:
        return grads, loss
    return grads, sum_over(loss.clone(), mesh, axes) / dp


def mesh_global_norm(grads, mesh, shards) -> torch.Tensor:
    """The one-device global norm of a rank's gradients: the squares of
    each split leaf summed over the axes that split it, every whole
    (replicated) leaf counted once."""
    groups: Dict[Tuple[str, ...], torch.Tensor] = {}
    for path, g in mod.walk(grads):
        shard = mod.get_path(shards, path) if shards is not None else None
        axes = () if shard is None else shard.axes
        sq = g.float().square().sum()
        groups[axes] = groups[axes] + sq if axes in groups else sq
    total = None
    for axes in sorted(groups):
        part = sum_over(groups[axes], mesh, axes) if axes else groups[axes]
        total = part if total is None else total + part
    return torch.sqrt(total)


def build_train_step(
    loss_fn: Callable[[Any, Dict], Tuple[torch.Tensor, Dict]],
    optimizer: Optimizer,
    *,
    grad_accum: int = 1,
    clip_norm: Optional[float] = 1.0,
    grad_transform: Optional[Callable] = None,   # e.g. compressed DP allreduce
    mesh=None,
    shards=None,
    dp_axis="data",
    grad_reduce: Optional[Callable] = None,
):
    """The train step. Under ``mesh`` (a ("data", "model") DeviceMesh; the
    step activates its ``axis_rules``) the params are a rank's blocks (``distributed.sharding.place_train_params`` with ``shards``):
    the step takes the rank's rows of the global batch over ``dp_axis``
    (``dp_rows``), averages the loss and gradients over it
    (``_mesh_grads``; ``grad_reduce``, a codec's mean, takes the exact
    mean's place for the gradients), clips by the one-device global norm
    (``mesh_global_norm``) and runs the optimizer on the local blocks: the
    one-device step's loss, gradients and update, up to f32 summation
    order."""
    if grad_reduce is not None and any(s.cols for _, s in mod.walk(shards)):
        raise ValueError("grad_reduce reduces the gradients over the data axis; "
                         "FSDP leaves come back reduced by their gather")

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
        if mesh is None:
            loss, aux, grads = microbatched_grads(state.params, batch)
        else:
            with axis_rules(mesh):
                loss, aux, grads = microbatched_grads(
                    state.params, dp_rows(batch, mesh, grad_accum, dp_axis))
            grads, loss = _mesh_grads(grads, loss, mesh, shards, dp_axis,
                                      grad_reduce)
        if grad_transform is not None:
            grads = grad_transform(grads)
        gnorm = torch.zeros((), device=loss.device)
        if clip_norm is not None:
            norm = None if mesh is None else mesh_global_norm(grads, mesh, shards)
            grads, gnorm = clip_by_global_norm(grads, clip_norm, norm=norm)
        new_params, new_opt = optimizer.update(grads, state.opt_state, state.params)
        metrics = {"loss": loss, "grad_norm": gnorm, **aux}
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step
