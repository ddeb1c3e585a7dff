"""Kernel B6: fused-im2col conv forward with a reused bit-packed tile.

Replaces ``repro/kernels/tiled_conv.py:68`` ``tiled_conv_unique`` (the
Pallas TPU kernel ``_conv_kernel``). The CUDA source is
``csrc/tiled_conv.cu`` with the Hopper mainloop it shares with B2 in
``csrc/hopper_gemm.cuh``; its header says what bounds the kernel on an
H100 (operations: an implicit GEMM of M = N*OH*OW pixels by r filters over
K = kh*kw*C) and how the design gathers the im2col rows straight from
NHWC into a ring of shared-memory tiles and builds the ±1 operand from the
packed words in registers, so neither the im2col matrix nor the dense
weight exists in device memory. :func:`plan_conv` picks the body, its tile
and the K split on the host.

``ops.tiled_conv_infer`` pads x (spatially, and channels to whole words)
and calls the wrapper. The wrapper calls the operator
``repro_torch::tiled_conv_unique`` (``kernels/_op.py``), which launches
the kernel for CUDA tensors and runs the plain PyTorch version only for
CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.core.packing import LANE_BITS
from repro_torch.kernels import _build
from repro_torch.kernels._op import kernel_op
from repro_torch.kernels.tiled_matmul import (
    STAGE_WORDS,
    TILE_M,
    TILE_N,
    Plan,
    _sm_count,
    best_plan,
    split_k,
    unpack_rows,
)

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


# B6's bf16 bodies (its producer gathers up to 128 pixels a tile)
CONV_BODIES = ("wg128x64", "wg128x128", "wg256x128")


def plan_conv(m: int, r: int, kernel: Tuple[int, int], words: int, sms: int,
              bf16: bool = True, body: str | None = None) -> Plan:
    """The plan of one B6 call over ``m`` output pixels on a card with
    ``sms`` SMs. f32 takes the FMA body, its 64 x 64 tiles splitting K
    steps (i, j, word) like B2 splits words; bf16 the Hopper body of least
    modelled time among CONV_BODIES (``body`` forces one; the card tests
    run each), over K stages (i, j, pair of words)."""
    kh, kw = kernel
    if not bf16:
        steps = kh * kw * words
        return Plan("fma", TILE_M, TILE_N, steps, *split_k(m, r, steps, sms))
    stages = kh * kw * -(-words // STAGE_WORDS)
    return best_plan([body] if body else CONV_BODIES, m, r, stages, sms)


@functools.lru_cache(maxsize=None)
def _launcher():
    """(library, bound launch function), built and loaded on first use."""
    lib = _build.load("tiled_conv")
    fn = lib.tbn_tiled_conv
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 15
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def call_plan(n: int, r: int, kernel: Tuple[int, int], words: int,
              out_hw: Tuple[int, int], sms: int, bf16: bool,
              body: str | None = None, plan_shape=None) -> Plan:
    """The plan of a B6 call on N images and r filters: :func:`plan_conv`
    for its m = N*OH*OW pixels and r, or for ``plan_shape`` (M, R) when the
    call is a rank's block of a larger one (M pixels, R filters), so the
    rank sums each element in the order one card sums the whole."""
    m = n * out_hw[0] * out_hw[1]
    pm, pr = plan_shape or (m, r)
    return plan_conv(pm, pr, kernel, words, sms, bf16, body)


def tiled_conv_unique(x: torch.Tensor, packed: torch.Tensor, *,
                      kernel: Tuple[int, int], stride: Tuple[int, int],
                      out_hw: Tuple[int, int], plan_shape=None) -> torch.Tensor:
    """u[n,oh,ow,:] = sum_{i,j} x[n, oh*sh+i, ow*sw+j, :] @ T[i,j]^T.

    x (N, Hp, Wp, C) bf16/f32 NHWC, already padded (Hp >= (OH-1)*sh + kh,
    Wp >= (OW-1)*sw + kw), C a multiple of 32; packed (kh*kw, r, C/32)
    int32 conv layout. Returns (N, OH, OW, r) float32. Launches kernel B6
    for CUDA tensors as :func:`call_plan` plans it (for ``plan_shape``
    (M, R) pixels and filters when given: a rank's block of a larger
    call); CPU tensors take the plain version."""
    check_operands(x, packed, kernel, stride, out_hw)
    return _conv_op(x, packed, list(kernel), list(stride), list(out_hw),
                    None if plan_shape is None else list(plan_shape))


def tiled_conv_body(x: torch.Tensor, packed: torch.Tensor, body: str, *,
                    kernel: Tuple[int, int], stride: Tuple[int, int],
                    out_hw: Tuple[int, int]) -> torch.Tensor:
    """Kernel B6 on bf16 CUDA tensors with the Hopper ``body`` forced in
    place of the planner's pick: the card checks hold every body against
    the plain version and time it beside the cost model."""
    check_operands(x, packed, kernel, stride, out_hw)
    if body not in CONV_BODIES or x.dtype != torch.bfloat16:
        raise ValueError(f"tiled_conv_body: body {body!r} on {x.dtype} x; "
                         f"expected bfloat16 and one of {CONV_BODIES}")
    return _launch(x, packed, kernel, stride, out_hw, body)


def _launch(x, packed, kernel, stride, out_hw, body, plan_shape=None
            ) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"tiled_conv_unique: no kernel for device {x.device}")
    if x.device.index not in (None, torch.cuda.current_device()):
        raise ValueError(f"tiled_conv_unique: x is on {x.device}, the current "
                         f"CUDA device is {torch.cuda.current_device()}")
    if x.data_ptr() % 16 or packed.data_ptr() % 4:
        raise ValueError("tiled_conv_unique: x must be 16-byte aligned")
    (kh, kw), (sh, sw), (oh, ow) = kernel, stride, out_hw
    n, hp, wp, _ = x.shape
    _, r, words = packed.shape
    m = n * oh * ow
    bf16 = x.dtype == torch.bfloat16
    out = torch.empty((n, oh, ow, r), dtype=torch.float32, device=x.device)
    plan = call_plan(n, r, kernel, words, out_hw, _sm_count(out.device.index),
                     bf16, body, plan_shape)
    work = (torch.empty((plan.splits, m, r), dtype=torch.float32,
                        device=x.device) if plan.splits > 1 else None)
    lib, launch = _launcher()
    err = launch(x.data_ptr(), packed.data_ptr(), out.data_ptr(),
                 None if work is None else work.data_ptr(), n, hp, wp, words,
                 r, kh, kw, sh, sw, oh, ow, plan.code, plan.splits,
                 plan.per_split, int(bf16),
                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "tiled_conv_unique")
    tiled_conv_unique.launches += 1
    return out


_conv_op = kernel_op(
    "tiled_conv_unique",
    "(Tensor x, Tensor packed, int[] kernel, int[] stride, int[] out_hw, "
    "int[]? plan_shape) -> Tensor",
    lambda x, packed, kernel, stride, out_hw, plan_shape: _launch(
        x, packed, tuple(kernel), tuple(stride), tuple(out_hw), None, plan_shape),
    lambda x, packed, kernel, stride, out_hw, plan_shape: tiled_conv_plain(
        x, packed, kernel=tuple(kernel), stride=tuple(stride), out_hw=tuple(out_hw)),
    lambda x, packed, kernel, stride, out_hw, plan_shape: x.new_empty(
        (x.shape[0], out_hw[0], out_hw[1], packed.shape[1]), dtype=torch.float32))
tiled_conv_unique.launches = 0
