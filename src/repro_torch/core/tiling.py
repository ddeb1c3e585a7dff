"""Tile planning, the training-time construction with its straight-through
estimator, the serve-side tile math and the conv plan (port of
``repro/core/tiling.py``).

A weight with N elements is compressed by p (N = p*q): reshape to (p, q),
sum over p, take the sign -> one ±1 tile t of length q, scaled by alpha
(one per layer, Eq. 7, or one per tile, Eq. 9). The reference's
``custom_vjp``s are ``torch.autograd.Function``s here.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.packing import packed_len

AlphaMode = Literal["layer", "tile"]
AlphaSource = Literal["W", "A"]
SteMode = Literal["identity", "autodiff"]


@dataclasses.dataclass(frozen=True)
class TileSpec:
    """Static description of how one weight tensor is tiled (see the
    reference for the field semantics; identical here)."""

    shape: Tuple[int, ...]
    p: int
    q: int
    aligned_rows: bool
    alpha_mode: AlphaMode = "tile"
    alpha_source: AlphaSource = "A"
    ste: SteMode = "identity"

    @property
    def n(self) -> int:
        return int(np.prod(self.shape))

    @property
    def rows_per_tile(self) -> int:
        if not self.aligned_rows:
            raise ValueError("rows_per_tile is only defined for aligned tiling")
        return self.shape[0] // self.p

    @property
    def n_alpha(self) -> int:
        return self.p if self.alpha_mode == "tile" else 1

    @property
    def stored_bits(self) -> int:
        """Bits stored at inference: q tile bits + fp32 alpha scalars."""
        return self.q + 32 * self.n_alpha


def plan_tiling(
    shape: Sequence[int],
    *,
    p: int,
    min_size: int = 64_000,
    alpha_mode: AlphaMode = "tile",
    alpha_source: AlphaSource = "A",
    ste: SteMode = "identity",
    require_aligned: bool = False,
) -> Optional[TileSpec]:
    """TileSpec for a weight of ``shape``, or None when it stays per-weight
    (below lambda, p <= 1, no divisor of N <= p, or unaligned when
    ``require_aligned``). Falls back to the largest divisor of N <= p."""
    shape = tuple(int(d) for d in shape)
    n = int(np.prod(shape))
    if p <= 1 or n < min_size:
        return None
    if n % p != 0:
        cand = [d for d in range(p, 1, -1) if n % d == 0]
        if not cand:
            return None
        p = cand[0]
    aligned = shape[0] % p == 0
    if require_aligned and not aligned:
        return None
    return TileSpec(shape=shape, p=p, q=n // p, aligned_rows=aligned,
                    alpha_mode=alpha_mode, alpha_source=alpha_source, ste=ste)


def _sign_pm1(x: torch.Tensor) -> torch.Tensor:
    """Paper Eq. 3: +1 where x > 0 else -1 (zero maps to -1)."""
    return torch.where(x > 0, 1.0, -1.0).to(x.dtype)


def aggregate(w: torch.Tensor, spec: TileSpec) -> torch.Tensor:
    """Eq. 1-2: reshape to (p, q) and sum over the replica axis -> s (q,)."""
    return w.reshape(spec.p, spec.q).sum(dim=0)


def tile_vector(w: torch.Tensor, spec: TileSpec) -> torch.Tensor:
    """Eq. 3: the binary tile t in {-1,+1}^q."""
    return _sign_pm1(aggregate(w, spec))


class _SteSign(torch.autograd.Function):
    """sign with the straight-through gradient (identity)."""

    @staticmethod
    def forward(ctx, x):
        return _sign_pm1(x)

    @staticmethod
    def backward(ctx, g):
        return g


def _ste_sign(x: torch.Tensor) -> torch.Tensor:
    return _SteSign.apply(x)


def _construct_binary_impl(w: torch.Tensor, spec: TileSpec) -> torch.Tensor:
    t = _ste_sign(aggregate(w, spec))
    # Eq. 4-5: b = 1_p (x) t, reshaped back to the tensor shape.
    return t[None, :].expand(spec.p, spec.q).reshape(spec.shape)


class _ConstructBinaryIdentity(torch.autograd.Function):
    """Paper Eq. 6: dy/dW ~= dy/dB, passed through the whole threshold /
    tile / reshape pipeline unchanged, elementwise."""

    @staticmethod
    def forward(ctx, w, spec):
        ctx.shape = spec.shape
        return _construct_binary_impl(w, spec)

    @staticmethod
    def backward(ctx, g):
        return g.reshape(ctx.shape), None


def construct_binary(w: torch.Tensor, spec: TileSpec) -> torch.Tensor:
    """Full-shape ±1 tensor B from the master W, with the STE.

    ``spec.ste == "identity"`` passes gradients through unchanged (the
    paper's autograd module); ``"autodiff"`` applies the STE to the sign
    only and differentiates the aggregation and tiling exactly."""
    if tuple(w.shape) != spec.shape:
        raise ValueError(f"weight shape {tuple(w.shape)} != spec shape {spec.shape}")
    if spec.ste == "identity":
        return _ConstructBinaryIdentity.apply(w, spec)
    return _construct_binary_impl(w, spec)


def compute_alpha(src: torch.Tensor, spec: TileSpec) -> torch.Tensor:
    """Eq. 7 / Eq. 9: (1,) for mode "layer", (p,) for mode "tile"; each
    alpha_i belongs to the i-th contiguous tile of the flattened tensor."""
    if spec.alpha_mode == "layer":
        return src.abs().mean().reshape(1)
    return src.reshape(spec.p, spec.q).abs().mean(dim=1)


def expand_alpha(alpha: torch.Tensor, spec: TileSpec) -> torch.Tensor:
    """Broadcast alpha scalars over the full tensor shape."""
    col = alpha.reshape(1, 1) if spec.alpha_mode == "layer" else alpha[:, None]
    return col.expand(spec.p, spec.q).reshape(spec.shape)


def tiled_weight(w: torch.Tensor, spec: TileSpec, a: Optional[torch.Tensor] = None,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The effective training-time weight B_hat = alpha ⊙ B (full shape).
    ``a`` must be given when ``spec.alpha_source == "A"``."""
    b = construct_binary(w, spec)
    src = a if spec.alpha_source == "A" else w
    if src is None:
        raise ValueError("alpha_source='A' requires the auxiliary tensor A")
    bhat = b * expand_alpha(compute_alpha(src, spec), spec)
    return bhat if dtype is None else bhat.to(dtype)


class _ConstructRowsIdentity(torch.autograd.Function):
    """Row-aligned binary construction by a sum over a real axis (no flat
    reshape), bit-identical to ``construct_binary`` for p | n_out; leading
    batch dims allowed. Backward: identity (Eq. 6)."""

    @staticmethod
    def forward(ctx, w, p):
        *lead, rows, d = w.shape
        r = rows // p
        t = _sign_pm1(w.reshape(*lead, p, r, d).sum(dim=-3))
        return t[..., None, :, :].expand(*lead, p, r, d).reshape(*lead, rows, d)

    @staticmethod
    def backward(ctx, g):
        return g, None


def tiled_weight_rows(w: torch.Tensor, spec: TileSpec,
                      a: Optional[torch.Tensor] = None,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``tiled_weight`` for row-aligned specs via axis ops only; handles
    leading batch dims."""
    if not spec.aligned_rows:
        raise ValueError("tiled_weight_rows needs row-aligned tiling")
    *lead, rows, d = w.shape
    p, r = spec.p, spec.rows_per_tile
    b = _ConstructRowsIdentity.apply(w, p)
    src = a if (spec.alpha_source == "A" and a is not None) else w
    if spec.alpha_mode == "layer":
        bhat = b * src.abs().mean(dim=(-1, -2), keepdim=True)
    else:
        alpha = src.reshape(*lead, p, r, d).abs().mean(dim=(-1, -2))   # (*lead, p)
        bhat = (b.reshape(*lead, p, r, d) * alpha[..., None, None]).reshape(
            *lead, rows, d)
    return bhat if dtype is None else bhat.to(dtype)


def export_tile(w: torch.Tensor, spec: TileSpec, a: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tile t ±1 (q,), alpha (n_alpha,)): the stored representation."""
    with torch.no_grad():
        src = a if spec.alpha_source == "A" else w
        return tile_vector(w, spec), compute_alpha(src, spec)


def reconstruct_from_tile(t: torch.Tensor, alpha: torch.Tensor, spec: TileSpec,
                          dtype=torch.float32) -> torch.Tensor:
    """Rebuild the dense effective weight from (t, alpha) — reference path.
    Leading axes of t (*lead, q) and alpha (*lead, n_alpha) are batch axes,
    as over an expert bank: (E, q) -> (E, *spec.shape); the reference vmaps
    over them."""
    lead = tuple(t.shape[:-1])
    b = t[..., None, :].expand(*lead, spec.p, spec.q)
    a = alpha.to(b.dtype)
    a = a.reshape(*lead, 1, 1) if spec.alpha_mode == "layer" else a[..., :, None]
    return (b * a).reshape(*lead, *spec.shape).to(dtype)


def tiled_matmul_reference(x: torch.Tensor, t: torch.Tensor,
                           alpha: torch.Tensor, spec: TileSpec) -> torch.Tensor:
    """y = x @ W_hat^T the tile-reuse way (aligned dense layers): u = x @ T^T
    once, then y[..., i*r:(i+1)*r] = alpha_i * u."""
    n_out, n_in = spec.shape[0], spec.n // spec.shape[0]
    if x.shape[-1] != n_in:
        raise ValueError(f"x trailing dim {x.shape[-1]} != n_in {n_in}")
    r = spec.rows_per_tile
    u = x @ t.reshape(r, n_in).T
    alpha = alpha.to(u.dtype)
    if spec.alpha_mode == "layer":
        y = u[..., None, :].expand(*u.shape[:-1], spec.p, r) * alpha.reshape(1)
    else:
        y = u[..., None, :] * alpha.reshape((1,) * (u.ndim - 1) + (spec.p, 1))
    return y.reshape(*x.shape[:-1], n_out)


# --------------------------------------------------------------------------
# Conv tiling plan: how the flat (p, q) tiling lands on an OIHW weight
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ConvTilePlan:
    """Structured view of an aligned tiling of an OIHW conv weight.

    For W (c_out, c_in, kh, kw) with p | c_out the flat row-major (p, q)
    tiling covers r = c_out / p complete filters per tile, so replica a of
    the tile is filters a*r .. (a+1)*r - 1: the conv runs against the
    r-filter bank once and the p replicas are a broadcast-scale by alpha.
    The shipped tile is in conv layout, (kh*kw, r, ceil(c_in/32)) int32
    (``core.packing.pack_conv_tile``)."""

    spec: TileSpec

    def __post_init__(self):
        if len(self.spec.shape) != 4:
            raise ValueError(f"conv plan needs a 4-D weight, got {self.spec.shape}")
        if not self.spec.aligned_rows:
            raise ValueError("conv plan needs p | c_out (aligned tiling)")

    @property
    def c_out(self) -> int:
        return self.spec.shape[0]

    @property
    def c_in(self) -> int:
        return self.spec.shape[1]

    @property
    def kernel(self) -> Tuple[int, int]:
        return (self.spec.shape[2], self.spec.shape[3])

    @property
    def r(self) -> int:
        """Filters covered by one tile."""
        return self.spec.rows_per_tile

    @property
    def kk(self) -> int:
        """Patch length: elements of one filter (the im2col contraction)."""
        return self.spec.n // self.spec.shape[0]

    @property
    def positions(self) -> int:
        return self.spec.shape[2] * self.spec.shape[3]

    def packed_shape(self) -> Tuple[int, int, int]:
        """Shipped conv-layout tile shape: (kh*kw, r, ceil(c_in/32))."""
        return (self.positions, self.r, packed_len(self.c_in))


def plan_conv_tiling(spec: Optional[TileSpec]) -> Optional[ConvTilePlan]:
    """ConvTilePlan for a conv TileSpec, or None when the tiled conv path
    does not apply (no tiling, not 4-D, unaligned: the layer then serves by
    dense reconstruction)."""
    if spec is None or len(spec.shape) != 4 or not spec.aligned_rows:
        return None
    return ConvTilePlan(spec=spec)


def conv_tile_bank(t: torch.Tensor, plan: ConvTilePlan, dtype=torch.float32
                   ) -> torch.Tensor:
    """The flat tile t (q,) as the r-filter OIHW bank (r, c_in, kh, kw)."""
    kh, kw = plan.kernel
    return t.reshape(plan.r, plan.c_in, kh, kw).to(dtype)
