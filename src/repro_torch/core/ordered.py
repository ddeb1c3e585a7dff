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


# XLA's CPU dot emitter: a batched product with at most this many rows (the
# non-contracted dims of its left operand) keeps 4 accumulators, one for
# each residue of the contraction index mod 4, fused multiply-adds, added
# pairwise at the end; a larger one accumulates sequentially with FMAs
XLA_SMALL_DOT_ROWS = 16


# the multiply-adds up to which a product on the host takes ordered_dot: it
# runs one vector op an accumulation step, so the parity tests' products
# (reduced configs) take it, and a larger one (the card checks' full-width
# CPU references, held to tolerance) takes PyTorch's own product
XLA_EXACT_MAX_MACS = 2 ** 26


def ordered_dot(a: torch.Tensor, b: torch.Tensor, rows: int) -> torch.Tensor:
    """f32 sum over the last axis of a * b (broadcast) in XLA's CPU dot
    order for a product of ``rows`` rows (``XLA_SMALL_DOT_ROWS``). Each FMA
    is rounded once: the f32 product is exact in f64, and the f64 sum is
    rounded to f32."""
    n = a.shape[-1]
    lanes = 4 if rows <= XLA_SMALL_DOT_ROWS else 1

    def fma_step(acc, lo, hi):      # acc + a[lo:hi] * b[lo:hi], rounded once
        return (acc.double() + a[..., lo:hi].double() * b[..., lo:hi].double()
                ).float()

    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    acc = torch.zeros((*shape, lanes), dtype=torch.float32, device=a.device)
    for i in range(0, n - n % lanes, lanes):        # every lane a step
        acc = fma_step(acc, i, i + lanes)
    rest = n % lanes                                 # the first lanes once more
    if rest:
        acc[..., :rest] = fma_step(acc[..., :rest], n - rest, n)
    parts = list(acc.unbind(-1))
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
    return parts[0]


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 fused multiply-add, rounded once (the f32 product is exact in
    f64; the f64 sum is rounded to f32)."""
    return (a.double() * torch.as_tensor(b, dtype=torch.float64)
            + torch.as_tensor(c, dtype=torch.float64)).float()


# XLA's CPU exp (its vectorized Cephes polynomial): the input clamped to
# +-88.8, n = floor(x log2(e) + 1/2) clamped to [-127, 127], the remainder
# r = x - n ln2 in two FMA steps (C1 + C2 = ln2), e^r by a degree-6
# polynomial in FMAs, times 2^n built from its exponent bits (0 at n =
# -127); subnormal results flush to zero
_EXP_LOG2E = 1.44269504088896341
_EXP_C1, _EXP_C2 = 0.693359375, -2.12194440e-4
_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
          1.6666665459e-1, 5.0000001201e-1)
_F32_MIN_NORMAL = 2.0 ** -126


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def xla_exp(x: torch.Tensor) -> torch.Tensor:
    """f32 exp in XLA's CPU arithmetic (comment above), bit for bit."""
    x = x.float().clamp(-88.8, 88.8)
    n = torch.floor(_fma(x, _f32(_EXP_LOG2E), _f32(0.5))).clamp(-127, 127)
    r = _fma(-_f32(_EXP_C1), n, x)
    r = _fma(-_f32(_EXP_C2), n, r)
    z = _fma(r, _f32(_EXP_P[0]), _f32(_EXP_P[1]))
    for p in _EXP_P[2:]:
        z = _fma(z, r, _f32(p))
    z = 1 + _fma(z, r * r, r)
    pow2 = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    out = z * torch.where(n <= -127, torch.zeros_like(pow2), pow2)
    return torch.where(out.abs() < _F32_MIN_NORMAL, torch.zeros_like(out), out)


def xla_softmax(s: torch.Tensor) -> torch.Tensor:
    """f32 softmax over the last axis as ``jax.nn.softmax`` computes it on
    the CPU: exp(s - max) in ``xla_exp``, divided by its ``ordered_sum``."""
    e = xla_exp(s - s.amax(-1, keepdim=True))
    return e / ordered_sum(e)
