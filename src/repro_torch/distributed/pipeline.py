"""GPipe pipeline parallelism over a 1-D ("stage",) mesh (port of
``repro/distributed/pipeline.py``).

Each rank along the "stage" mesh dim holds one contiguous slice of layers.
Microbatches stream through: at tick t, stage s computes microbatch t - s
and hands its activation to stage s+1 with a point-to-point send, an
``autograd.Function`` whose backward sends the gradient upstream, so the
backward runs the schedule in reverse. Each rank runs its microbatches in
order and a receive waits for its sender, which paces the ticks. Remat
inside the stage (``torch.utils.checkpoint``) keeps the bubble's live set
small.

Schedule (classic GPipe): M microbatches, S stages, M + S - 1 ticks,
bubble fraction (S-1)/(M+S-1). A stage computes only the ticks that carry
a microbatch (the reference's SPMD stages also compute the bubble's).

The last stage's outputs are broadcast to every stage. The gradient is
the one of the stages run in sequence (DESIGN.md §5): every rank computes
the same loss on the broadcast outputs, and the broadcast's backward
keeps the last stage's own gradient, so the loss counts once.

This is the depth-scaling option for deployments whose (data, model) mesh
is exhausted; like the reference, the train CLI does not wire it.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch.nn import module as mod


def _exchange(send: torch.Tensor = None, dst: int = None,
              recv: torch.Tensor = None, src: int = None) -> None:
    """Post the receive, then the send, and wait for both (``recv`` is
    filled in place). gloo moves host memory only, so a card tensor is
    staged through the host there."""
    stage = dist.get_backend() == "gloo"
    rbuf = recv.cpu() if stage and recv is not None and recv.is_cuda else recv
    sbuf = send
    if send is not None:
        sbuf = send.detach().contiguous()
        sbuf = sbuf.cpu() if stage and sbuf.is_cuda else sbuf
    works = []
    if rbuf is not None:
        works.append(dist.irecv(rbuf, src=src))
    if sbuf is not None:
        works.append(dist.isend(sbuf, dst=dst))
    for w in works:
        w.wait()
    if rbuf is not recv:
        recv.copy_(rbuf)


class _SendDown(torch.autograd.Function):
    """Forward: send ``y`` to the next stage; returns a scalar zero that the
    pipeline adds into its outputs, so every stage's backward reaches this
    node. Backward: receive the gradient of ``y`` from the next stage."""

    @staticmethod
    def forward(ctx, y, dst):
        ctx.dst, ctx.like = dst, torch.empty_like(y)
        _exchange(send=y, dst=dst)
        return y.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        g = ctx.like
        _exchange(recv=g, src=ctx.dst)
        return g, None


class _RecvUp(torch.autograd.Function):
    """Forward: receive an activation from the previous stage (``anchor``
    is an empty tensor that requires grad, so the node is in the graph).
    Backward: send its gradient to the previous stage."""

    @staticmethod
    def forward(ctx, anchor, shape, dtype, src):
        ctx.src = src
        buf = torch.empty(shape, dtype=dtype, device=anchor.device)
        _exchange(recv=buf, src=src)
        return buf

    @staticmethod
    def backward(ctx, g):
        _exchange(send=g, dst=ctx.src)
        return None, None, None, None


class _FromLast(torch.autograd.Function):
    """Forward: the last stage's ``outs`` broadcast to every stage.
    Backward: the last stage keeps its own gradient (every stage computed
    the same loss), the others pass none."""

    @staticmethod
    def forward(ctx, outs, src, is_last):
        ctx.is_last = is_last
        # gloo has no bf16 broadcast: it goes as f32 (exact both ways)
        wide = outs.detach().float() if outs.dtype == torch.bfloat16 else (
            outs.detach().clone())
        dist.broadcast(wide, src=src)
        return wide.to(outs.dtype)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.is_last else torch.zeros_like(g)), None, None


def pipeline_forward(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                     stage_params: Any, x: torch.Tensor, mesh, *,
                     axis: str = "stage") -> torch.Tensor:
    """Run the GPipe schedule, one stage per rank of ``mesh``'s ``axis``.

    stage_fn(params, x_mb) -> y_mb applies THIS rank's layers (same shape
    and dtype in and out). x (M, mb, ...) holds all M microbatches; stage 0
    feeds them in order. Returns the last stage's outputs in microbatch
    order on every stage."""
    s = mesh.get_local_rank(axis)
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    ranks = mesh.mesh.flatten().tolist()
    m = x.shape[0]
    mb_shape, dtype = tuple(x.shape[1:]), x.dtype
    anchor = torch.zeros(0, device=x.device, requires_grad=True)
    outs, sent = [], []
    # stage s takes microbatch i at tick i + s: its activation from stage
    # s-1, sent at tick i + s - 1, is received just before it is used
    for i in range(m):
        x_in = x[i] if s == 0 else _RecvUp.apply(anchor, mb_shape, dtype,
                                                  ranks[s - 1])
        y = checkpoint(stage_fn, stage_params, x_in, use_reentrant=False)
        if s < n_stages - 1:
            sent.append(_SendDown.apply(y, ranks[s + 1]))
        else:
            outs.append(y)
    last = s == n_stages - 1
    local = (torch.stack(outs) if last else
             torch.zeros((m,) + mb_shape, dtype=dtype, device=x.device))
    y = _FromLast.apply(local, ranks[-1], last)
    return y + sum(sent) if sent else y


def build_gpipe_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                      mesh, *, axis: str = "stage"):
    """GPipe apply: (stacked stage params, leading dim S, (M, mb, ...) x)
    -> (M, mb, ...) y, each rank applying its stage's slice."""
    def apply(stacked_params, x):
        s = mesh.get_local_rank(axis)
        local = mod.map_tree(lambda v: v[s], stacked_params)
        return pipeline_forward(stage_fn, local, x, mesh, axis=axis)

    return apply


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
