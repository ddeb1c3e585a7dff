"""Tile planning and the serve-side tile math (port of the serve subset of
``repro/core/tiling.py``).

A weight with N elements is compressed by p (N = p*q): reshape to (p, q),
sum over p, take the sign -> one ±1 tile t of length q, scaled by alpha
(one per layer, Eq. 7, or one per tile, Eq. 9). The straight-through
estimator and the training-time construction wait for the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional, Sequence, Tuple

import numpy as np
import torch

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


def reconstruct_from_tile(t: torch.Tensor, alpha: torch.Tensor, spec: TileSpec,
                          dtype=torch.float32) -> torch.Tensor:
    """Rebuild the dense effective weight from (t, alpha) — reference path."""
    b = t[None, :].expand(spec.p, spec.q).reshape(spec.shape)
    return (b * expand_alpha(alpha.to(b.dtype), spec)).to(dtype)


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
