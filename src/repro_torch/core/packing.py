"""Bit packing for tile vectors (port of ``repro/core/packing.py``).

Bit order: bit j of word i encodes element ``i*32 + j`` (little-endian
within the word). +1 -> bit 1, -1 -> bit 0. q is padded to a multiple of
32 with zero bits (consumers slice back to q).

torch's uint32 support is thin, so packing accumulates in int64 and wraps
the result to int32 (two's complement, so a word with bit 31 set comes out
negative exactly as the reference's ``uint32 -> int32`` cast does).
Unpacking uses ``(w >> j) & 1``, which is exact under the arithmetic
(sign-extending) shift of a negative int32.
"""
from __future__ import annotations

import torch

LANE_BITS = 32


def packed_len(q: int) -> int:
    return (q + LANE_BITS - 1) // LANE_BITS


def pack_bits(t: torch.Tensor) -> torch.Tensor:
    """±1 (or {0,1}) values (..., q) -> int32 (..., ceil(q/32))."""
    q = t.shape[-1]
    bits = (t > 0).to(torch.int64)
    pad = packed_len(q) * LANE_BITS - q
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    words = bits.reshape(*t.shape[:-1], packed_len(q), LANE_BITS)
    shifts = torch.arange(LANE_BITS, dtype=torch.int64, device=t.device)
    packed = (words << shifts).sum(dim=-1)
    packed = torch.where(packed >= 2**31, packed - 2**32, packed)
    return packed.to(torch.int32)


def unpack_bits(packed: torch.Tensor, q: int, dtype=torch.float32) -> torch.Tensor:
    """int32 (..., ceil(q/32)) -> ±1 values (..., q) of ``dtype``."""
    shifts = torch.arange(LANE_BITS, dtype=torch.int32, device=packed.device)
    bits = (packed.to(torch.int32)[..., :, None] >> shifts) & 1
    flat = bits.reshape(*packed.shape[:-1], packed.shape[-1] * LANE_BITS)[..., :q]
    return (flat * 2 - 1).to(dtype)
