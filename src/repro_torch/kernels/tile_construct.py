"""Kernel B5: training-time tile construction, (p, q) master -> (packed
tile, per-tile alpha).

Replaces ``repro/kernels/tile_construct.py:48`` ``tile_construct_pallas``
(the Pallas TPU kernel ``_construct_kernel``). The CUDA source is
``csrc/tile_construct.cu``; its header says what bounds the kernel on an
H100 (memory: one read of the f32 masters) and how the design keeps the
column sums in a fixed order and alpha free of float atomics.

``ops.tile_construct`` pads q to a multiple of 32 and calls this once per
tiled Dense per forward pass of the fused training path
(``ModelContext(fused_train=True)``). The wrapper calls the operator
``repro_torch::tile_construct`` (``kernels/_op.py``), which launches the
kernel for CUDA tensors and runs the plain PyTorch version only for CPU
tensors.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core.packing import LANE_BITS, pack_bits
from repro_torch.kernels import _build
from repro_torch.kernels._op import kernel_op

_DTYPES = (torch.float32, torch.bfloat16)


def _check(w2d: torch.Tensor, a2d: Optional[torch.Tensor]) -> None:
    what = "tile_construct_kernel"
    if w2d.ndim != 2:
        raise ValueError(f"{what}: w2d must be (p, q), got {tuple(w2d.shape)}")
    if w2d.dtype not in _DTYPES:
        raise TypeError(f"{what}: w2d must be float32 or bfloat16, got {w2d.dtype}")
    p, q = w2d.shape
    if p < 1 or q < LANE_BITS or q % LANE_BITS:
        raise ValueError(f"{what}: q={q} must be a positive multiple of 32 "
                         f"(ops.tile_construct pads), p={p} >= 1")
    if not w2d.is_contiguous():
        raise ValueError(f"{what}: w2d must be contiguous")
    if a2d is not None:
        if (a2d.shape != w2d.shape or a2d.dtype != w2d.dtype
                or a2d.device != w2d.device or not a2d.is_contiguous()):
            raise ValueError(f"{what}: a2d must match w2d's shape, dtype and "
                             f"device and be contiguous")


def tile_construct_plain(w2d: torch.Tensor, a2d: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of B5. The column sum adds the p rows in
    the kernel's fixed order i = 0..p-1 in f32 (not ``torch.sum``, whose
    order is its own), so the tile words equal the kernel's exactly;
    alpha = sum|A| / q per row."""
    p, q = w2d.shape
    s = w2d[0].float()
    for i in range(1, p):
        s = s + w2d[i].float()
    src = w2d if a2d is None else a2d
    return pack_bits(s), src.float().abs().sum(dim=1) / q


@functools.lru_cache(maxsize=None)
def _launcher():
    """(library, bound launch function, columns per block), built and
    loaded on first use."""
    lib = _build.load("tile_construct")
    fn = lib.tbn_tile_construct
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.tbn_tile_construct_cols_per_block.restype = ctypes.c_int
    return lib, fn, lib.tbn_tile_construct_cols_per_block()


def tile_construct_kernel(w2d: torch.Tensor, a2d: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(p, q) master weight [, (p, q) alpha source] -> (packed int32
    (q/32,), alpha (p,) float32 = sum|A| / q per tile). Callers pass
    ``a2d`` None when alpha comes from W (``ops.tile_construct`` does so for
    ``alpha_source="W"``), and the kernel then reads W once. Launches
    kernel B5 for CUDA tensors; CPU tensors take the plain version."""
    _check(w2d, a2d)
    return _construct_op(w2d, a2d)


def _launch(w2d: torch.Tensor, a2d: Optional[torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    if w2d.device.index not in (None, torch.cuda.current_device()):
        raise ValueError(f"tile_construct_kernel: w2d is on {w2d.device}, the "
                         f"current CUDA device is {torch.cuda.current_device()}")
    p, q = w2d.shape
    lib, launch, cols_per_block = _launcher()
    blocks = -(-q // cols_per_block)
    dev = w2d.device
    packed = torch.empty((q // LANE_BITS,), dtype=torch.int32, device=dev)
    partial = torch.empty((blocks, p), dtype=torch.float32, device=dev)
    alpha = torch.empty((p,), dtype=torch.float32, device=dev)
    err = launch(w2d.data_ptr(), None if a2d is None else a2d.data_ptr(),
                 packed.data_ptr(), partial.data_ptr(), alpha.data_ptr(), p, q,
                 int(w2d.dtype == torch.bfloat16),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "tile_construct_kernel")
    tile_construct_kernel.launches += 1
    return packed, alpha


_construct_op = kernel_op(
    "tile_construct", "(Tensor w2d, Tensor? a2d) -> (Tensor, Tensor)",
    _launch, lambda w2d, a2d: tile_construct_plain(w2d, a2d),
    lambda w2d, a2d: (w2d.new_empty((w2d.shape[1] // LANE_BITS,), dtype=torch.int32),
                      w2d.new_empty((w2d.shape[0],), dtype=torch.float32)))
tile_construct_kernel.launches = 0
