"""Plain-torch oracles for the tiled kernels (port of the matmul/matvec
oracles of ``repro/kernels/ref.py``)."""
from __future__ import annotations

import torch

from repro_torch.core.packing import unpack_bits


def tiled_matmul_unique_ref(x: torch.Tensor, packed: torch.Tensor, *, r: int
                            ) -> torch.Tensor:
    """Oracle of the kernel's inner product: u = x @ T^T (M, r) from a
    FLAT packed tile of r*K bits."""
    m, k = x.shape
    t = unpack_bits(packed, r * k, dtype=torch.float32).reshape(r, k)
    return x.float() @ t.T


def tiled_matvec_unique_ref(x: torch.Tensor, packed_rows: torch.Tensor, *,
                            n_in: int) -> torch.Tensor:
    """Oracle for the decode matvec from a ROW-packed tile: x (M, K >= n_in,
    pad columns zero), packed_rows (r, ceil(n_in/32)) -> (M, r) float32."""
    t = unpack_bits(packed_rows, n_in, dtype=torch.float32)
    return x[:, :n_in].float() @ t.T
