"""Plain-torch oracles for the tiled kernels (port of the construction,
matmul, matvec, xnor, int8 and conv oracles of ``repro/kernels/ref.py``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.packing import pack_bits, unpack_bits, unpack_conv_tile
from repro_torch.core.tiling import TileSpec, expand_alpha, plan_conv_tiling
from repro_torch.kernels.ops import Padding, pad_nhwc


def tile_construct_ref(w2d: torch.Tensor, a2d: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(p, q) master weight -> (packed tile int32 (ceil(q/32),), alpha (p,)).
    alpha is per tile (Eq. 9); Eq. 7's layer alpha is its mean."""
    t = torch.where(w2d.sum(dim=0) > 0, 1.0, -1.0)
    src = w2d if a2d is None else a2d
    return pack_bits(t), src.abs().mean(dim=1).float()


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


def _pm1_dot(a: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(m, n) x (r, n) integers -> (m, r) int32 by an int64 elementwise
    product and sum (torch has no integer matmul on every device)."""
    return (a.long()[:, None, :] * t.long()[None, :, :]).sum(-1).to(torch.int32)


def tiled_xnor_matvec_ref(packed_x: torch.Tensor, packed_rows: torch.Tensor,
                          *, n_in: int) -> torch.Tensor:
    """Integer-exact oracle for the XNOR decode matvec: both operands
    unpacked to ±1 over their first n_in bits, then an integer dot ->
    (m, r) int32. Independent of the SWAR popcount of the plain version."""
    return _pm1_dot(unpack_bits(packed_x, n_in, dtype=torch.int64),
                    unpack_bits(packed_rows, n_in, dtype=torch.int64))


def tiled_int8_matvec_ref(q: torch.Tensor, packed_rows: torch.Tensor, *,
                          n_in: int) -> torch.Tensor:
    """Integer-exact oracle for the int8 x binary decode matvec: q (m,
    k >= n_in) int8 against the rows unpacked to ±1 -> (m, r) int32."""
    return _pm1_dot(q[:, :n_in], unpack_bits(packed_rows, n_in,
                                             dtype=torch.int64))


def tiled_conv_dense_weight(packed: torch.Tensor, alpha: torch.Tensor,
                            spec: TileSpec, dtype=torch.float32) -> torch.Tensor:
    """The FULL dense OIHW weight rebuilt from a conv-layout packed tile:
    ground truth only, the materialization the tiled conv path avoids."""
    plan = plan_conv_tiling(spec)
    kh, kw = plan.kernel
    bank = unpack_conv_tile(packed, plan.r, plan.c_in, kh, kw, dtype=dtype)
    w = bank[None].expand(spec.p, *bank.shape).reshape(spec.shape)
    return (w * expand_alpha(alpha.to(dtype), spec)).to(dtype)


def tiled_conv_ref(x: torch.Tensor, packed: torch.Tensor, alpha: torch.Tensor,
                   spec: TileSpec, *, stride=(1, 1), padding: Padding = "SAME"
                   ) -> torch.Tensor:
    """Dense ground truth for ``ops.tiled_conv_infer``: W_hat materialized,
    the reference's (asymmetric) padding applied explicitly, then
    ``F.conv2d`` in f32 with cuDNN's TF32 off. NHWC in and out."""
    w = tiled_conv_dense_weight(packed, alpha, spec, dtype=torch.float32)
    xp = pad_nhwc(x.float(), spec.shape[2:], stride, padding)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv2d(xp.permute(0, 3, 1, 2), w, stride=tuple(stride))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return y.permute(0, 2, 3, 1)
