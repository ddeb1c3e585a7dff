"""f32 reductions in the reference's summation order on the CPU.

XLA's CPU backend rewrites a long f32 reduction into a tree of
reduce-windows (its ``TreeReductionRewriter``): the reduced axis is padded
with zeros to a multiple of ``XLA_REDUCE_WINDOW``, the pad split as
``pad // 2`` zeros before and the rest after, each window of 32 is summed
in order from a zero accumulator, and the windows' partials are reduced
the same way until at most 32 are left, which a last reduce sums in order.
A mean is that sum times the f32 reciprocal of n (XLA turns the division
by a constant into a multiplication).

The parity paths that need the reference's bits on the host use these:
``LayerNorm``'s mean, the xnor path's per-row activation scale and the
EF-sign gradient codec. On the card the sums go through PyTorch's own
reductions and are held to the reference by tolerance.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

XLA_REDUCE_WINDOW = 32


def _sum_in_order(t: torch.Tensor) -> torch.Tensor:
    """Sequential sum over the last axis from a zero accumulator, kept as
    a length-1 axis."""
    acc = torch.zeros_like(t[..., :1])
    for i in range(t.shape[-1]):
        acc = acc + t[..., i:i + 1]
    return acc


def ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """f32 sum over the last axis of ``x`` (any length), keepdim, in XLA's
    CPU order (module docstring)."""
    part = x.float()
    while part.shape[-1] > XLA_REDUCE_WINDOW:
        n = part.shape[-1]
        pad = (-n) % XLA_REDUCE_WINDOW
        if pad:
            part = F.pad(part, (pad // 2, pad - pad // 2))
        w = part.unflatten(-1, (-1, XLA_REDUCE_WINDOW))
        acc = torch.zeros_like(w[..., 0])
        for i in range(XLA_REDUCE_WINDOW):
            acc = acc + w[..., i]
        part = acc
    return _sum_in_order(part)


def ordered_sum_all(x: torch.Tensor) -> torch.Tensor:
    """f32 sum of every element of ``x`` (a 0-d tensor) in XLA's CPU order
    for a reduction over all dims: while any dim is longer than 32, each
    dim d is padded (split as above) to a multiple of its window min(d, 32)
    and every window block is summed in row-major order from zero; the last
    partials are summed in row-major order."""
    part = x.float()
    w = XLA_REDUCE_WINDOW
    while any(d > w for d in part.shape):
        win = [min(d, w) for d in part.shape]
        pads = []
        for d, k in zip(part.shape, win):
            pad = (-d) % k
            pads.append((pad // 2, pad - pad // 2))
        part = F.pad(part, [v for lo_hi in reversed(pads) for v in lo_hi])
        split = []
        for d, k in zip(part.shape, win):
            split += [d // k, k]
        nd = part.ndim
        blocks = part.reshape(split).permute(
            *range(0, 2 * nd, 2), *range(1, 2 * nd, 2)).flatten(nd)
        acc = torch.zeros_like(blocks[..., 0])
        for i in range(blocks.shape[-1]):
            acc = acc + blocks[..., i]
        part = acc
    return _sum_in_order(part.reshape(1, -1)).reshape(())


def ordered_mean(x: torch.Tensor) -> torch.Tensor:
    """f32 mean over the last axis, keepdim: ``ordered_sum`` times
    ``float32(1 / n)``, as ``jnp.mean`` computes it on the CPU."""
    n = x.shape[-1]
    return ordered_sum(x) * float(np.float32(1) / np.float32(n))
