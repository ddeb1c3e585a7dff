"""Kernel B6: fused-im2col conv forward with a reused bit-packed tile.

Replaces ``repro/kernels/tiled_conv.py:68`` ``tiled_conv_unique`` (the
Pallas TPU kernel ``_conv_kernel``). The CUDA source is
``csrc/tiled_conv.cu``; its header says what bounds the kernel on an H100
(operations: an implicit GEMM of M = N*OH*OW pixels by r filters over
K = kh*kw*C) and how the design gathers the im2col rows straight from
NHWC and builds the ±1 operand from the packed words in registers, so
neither the im2col matrix nor the dense weight exists in device memory.

``ops.tiled_conv_infer`` pads x (spatially, and channels to whole words)
and calls the wrapper. The wrapper launches the kernel for CUDA tensors
and runs the plain PyTorch version only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.core.packing import LANE_BITS
from repro_torch.kernels import _build
from repro_torch.kernels.tiled_matmul import _sm_count, split_k, unpack_rows

_DTYPES = (torch.bfloat16, torch.float32)


def check_operands(x: torch.Tensor, packed: torch.Tensor, kernel, stride,
                   out_hw) -> None:
    """The operand contract of B6: x (N, Hp, Wp, words*32) bf16/f32, packed
    (kh*kw, r, words) int32, both contiguous and on one device, and every
    patch read in bounds."""
    what = "tiled_conv_unique"
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: x must be bfloat16 or float32, got {x.dtype}")
    if packed.dtype != torch.int32:
        raise TypeError(f"{what}: packed must be int32, got {packed.dtype}")
    if x.ndim != 4 or packed.ndim != 3:
        raise ValueError(f"{what}: x must be 4-D NHWC and packed 3-D, got "
                         f"{tuple(x.shape)} and {tuple(packed.shape)}")
    (kh, kw), (sh, sw), (oh, ow) = kernel, stride, out_hw
    n, hp, wp, c = x.shape
    if packed.shape[0] != kh * kw or c != packed.shape[2] * LANE_BITS:
        raise ValueError(f"{what}: packed {tuple(packed.shape)} does not fit "
                         f"kernel {kernel} and {c} channels")
    if min(n, packed.shape[1], oh, ow, sh, sw) < 1:
        raise ValueError(f"{what}: empty operand or bad stride: x "
                         f"{tuple(x.shape)}, packed {tuple(packed.shape)}, "
                         f"out {out_hw}, stride {stride}")
    if hp < (oh - 1) * sh + kh or wp < (ow - 1) * sw + kw:
        raise ValueError(f"{what}: x {tuple(x.shape)} is too small for out "
                         f"{out_hw} at kernel {kernel}, stride {stride}")
    if not (x.is_contiguous() and packed.is_contiguous()):
        raise ValueError(f"{what}: x and packed must be contiguous")
    if x.device != packed.device:
        raise ValueError(f"{what}: x on {x.device}, packed on {packed.device}")


def tiled_conv_plain(x: torch.Tensor, packed: torch.Tensor, *,
                     kernel: Tuple[int, int], stride: Tuple[int, int],
                     out_hw: Tuple[int, int]) -> torch.Tensor:
    """The plain PyTorch version of B6, the TPU kernel's own arithmetic: for
    each kernel position (i, j) in order, the strided (M, C) slice of x
    times the unpacked (r, C) cross-section, summed in f32."""
    (kh, kw), (sh, sw), (oh, ow) = kernel, stride, out_hw
    n, c = x.shape[0], x.shape[3]
    r = packed.shape[1]
    u = torch.zeros((n * oh * ow, r), dtype=torch.float32, device=x.device)
    for i in range(kh):
        for j in range(kw):
            patch = x[:, i:i + (oh - 1) * sh + 1:sh, j:j + (ow - 1) * sw + 1:sw, :]
            u += patch.reshape(-1, c).float() @ unpack_rows(packed[i * kw + j]).T
    return u.reshape(n, oh, ow, r)


@functools.lru_cache(maxsize=None)
def _launcher():
    """(library, bound launch function), built and loaded on first use."""
    lib = _build.load("tiled_conv")
    fn = lib.tbn_tiled_conv
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 14
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def tiled_conv_unique(x: torch.Tensor, packed: torch.Tensor, *,
                      kernel: Tuple[int, int], stride: Tuple[int, int],
                      out_hw: Tuple[int, int]) -> torch.Tensor:
    """u[n,oh,ow,:] = sum_{i,j} x[n, oh*sh+i, ow*sw+j, :] @ T[i,j]^T.

    x (N, Hp, Wp, C) bf16/f32 NHWC, already padded (Hp >= (OH-1)*sh + kh,
    Wp >= (OW-1)*sw + kw), C a multiple of 32; packed (kh*kw, r, C/32)
    int32 conv layout. Returns (N, OH, OW, r) float32. Launches kernel B6
    for CUDA tensors; CPU tensors take the plain version."""
    check_operands(x, packed, kernel, stride, out_hw)
    if x.device.type == "cpu":
        return tiled_conv_plain(x, packed, kernel=kernel, stride=stride,
                                out_hw=out_hw)
    if x.device.index not in (None, torch.cuda.current_device()):
        raise ValueError(f"tiled_conv_unique: x is on {x.device}, the current "
                         f"CUDA device is {torch.cuda.current_device()}")
    if x.data_ptr() % 16 or packed.data_ptr() % 4:
        raise ValueError("tiled_conv_unique: x must be 16-byte aligned")
    (kh, kw), (sh, sw), (oh, ow) = kernel, stride, out_hw
    n, hp, wp, _ = x.shape
    _, r, words = packed.shape
    m = n * oh * ow
    out = torch.empty((n, oh, ow, r), dtype=torch.float32, device=x.device)
    # K steps are (i, j, word): split them like B2 splits its words
    splits, per = split_k(m, r, kh * kw * words, _sm_count(out.device.index))
    work = (torch.empty((splits, m, r), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    lib, launch = _launcher()
    err = launch(x.data_ptr(), packed.data_ptr(), out.data_ptr(),
                 None if work is None else work.data_ptr(), n, hp, wp, words,
                 r, kh, kw, sh, sw, oh, ow, splits, per,
                 int(x.dtype == torch.bfloat16),
                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "tiled_conv_unique")
    tiled_conv_unique.launches += 1
    return out


tiled_conv_unique.launches = 0
