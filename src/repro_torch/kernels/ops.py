"""Serving-time tiled dense layer (port of the float path of
``repro/kernels/ops.py`` ``tiled_dense_infer``).

``tiled_dense_infer`` computes y = x @ W_hat^T from the shipped (packed
tile, alpha) form without materializing the dense weight: u = x @ T^T
against the r = n_out/p unique rows, then the p replicas are a
broadcast-scale by alpha. The m-dispatch is the reference's
``_dense_unique_local``: m <= ``MATVEC_MAX_M`` (after flattening lead
dims) goes to kernel B1 (``tiled_matvec_unique``), larger m to kernel B2
(``tiled_matmul_unique``). Dispatch between kernel and plain version
follows the tensor's device, inside the two wrappers.

Tile layouts: row-packed ``(r, ceil(n_in/32))`` (the shipped serve form)
or flat ``(ceil(q/32),)``. A flat tile is the same bits as the rows only
when 32 | n_in; on the kernel path anything else raises
``FlatTileLayoutError``. On CPU a flat tile takes the reference's
``tiled_matmul_reference`` branch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.packing import LANE_BITS, unpack_bits
from repro_torch.core.tiling import TileSpec, tiled_matmul_reference
from repro_torch.kernels.tiled_matmul import tiled_matmul_unique
from repro_torch.kernels.tiled_matvec import MATVEC_MAX_M, tiled_matvec_unique

COMPUTE_PATHS = ("float", "int8", "xnor")
INT_PATH_ITEM = "ROADMAP.md queue A item 7 (integer decode paths)"


class FlatTileLayoutError(ValueError):
    """Flat-form packed tile fed to the kernel path with 32 ∤ n_in: row
    boundaries fall mid-word, so the flat bit stream cannot be viewed as
    (r, n_in/32) packed rows."""


def check_compute_path(compute_path: str) -> None:
    if compute_path not in COMPUTE_PATHS:
        raise ValueError(f"unknown compute_path {compute_path!r}: expected "
                         f"one of {COMPUTE_PATHS}")
    if compute_path != "float":
        raise NotImplementedError(
            f"compute_path {compute_path!r} is not ported yet: {INT_PATH_ITEM}")


def _dense_unique_local(xm: torch.Tensor, packed_rows: torch.Tensor
                        ) -> torch.Tensor:
    """u = x @ T^T (m, r) float32 against a row-packed tile. x is padded
    with zero columns to words*32 (pad bits unpack to -1 but only ever meet
    those zero columns); m <= MATVEC_MAX_M takes B1, larger m takes B2."""
    words = packed_rows.shape[1]
    pad = words * LANE_BITS - xm.shape[1]
    xp = F.pad(xm, (0, pad)) if pad else xm.contiguous()
    if xp.shape[0] <= MATVEC_MAX_M:
        return tiled_matvec_unique(xp, packed_rows)
    return tiled_matmul_unique(xp, packed_rows)


def _replicate_dense_out(u: torch.Tensor, alpha: torch.Tensor, spec: TileSpec
                         ) -> torch.Tensor:
    """u (m, r) -> y (m, p, r): the tile-replica broadcast-scale."""
    m, r = u.shape
    alpha = alpha.to(u.dtype)
    if spec.alpha_mode == "layer":
        return u[:, None, :].expand(m, spec.p, r) * alpha.reshape(1)
    return u[:, None, :] * alpha[None, :, None]


def tiled_dense_infer(x: torch.Tensor, packed: torch.Tensor,
                      alpha: torch.Tensor, spec: TileSpec, *,
                      compute_path: str = "float") -> torch.Tensor:
    """y = x @ W_hat^T from the shipped representation.

    x (..., n_in); packed int32, row-packed (r, ceil(n_in/32)) or flat
    (ceil(q/32),); alpha (n_alpha,). Weight logical shape spec.shape ==
    (n_out, n_in), aligned tiling. Returns (..., n_out) in x's dtype."""
    check_compute_path(compute_path)
    n_out, n_in = spec.shape[0], spec.n // spec.shape[0]
    r = spec.rows_per_tile
    lead = x.shape[:-1]
    xm = x.reshape(-1, n_in)
    if packed.ndim != 2:
        if x.device.type == "cpu":
            t = unpack_bits(packed, spec.q, dtype=x.dtype)
            y = tiled_matmul_reference(xm, t, alpha, spec)
            return y.reshape(*lead, n_out).to(x.dtype)
        if n_in % LANE_BITS:
            raise FlatTileLayoutError(
                f"flat-form packed tile cannot be viewed as packed rows: "
                f"n_in={n_in} is not a multiple of 32 (spec.shape="
                f"{spec.shape}), so row boundaries fall mid-word. Ship the "
                f"row-packed (r, ceil(n_in/32)) serve form for the kernel "
                f"path.")
        packed = packed.reshape(r, n_in // LANE_BITS)
    y3 = _replicate_dense_out(_dense_unique_local(xm, packed), alpha, spec)
    return y3.reshape(*lead, n_out).to(x.dtype)
