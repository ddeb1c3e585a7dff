"""Kernel B2: fully-connected forward with a reused bit-packed tile, any m.

Replaces ``repro/kernels/tiled_matmul.py:69`` ``tiled_matmul_unique`` (the
Pallas TPU kernel ``_matmul_kernel`` with ``_unpack_block``). The CUDA
source is ``csrc/tiled_matmul.cu``; its header says what bounds the kernel
on an H100 (operations: chunked prefill runs m = n_slots * chunk_tokens
rows) and how the design keeps the dense ±1 weight out of device memory.

The wrapper launches the kernel for CUDA tensors and runs the plain
PyTorch version (unpack to ±1, ``x.float() @ t.T``) only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.packing import LANE_BITS, unpack_bits
from repro_torch.kernels import _build

_DTYPES = (torch.bfloat16, torch.float32)


def check_operands(x: torch.Tensor, packed: torch.Tensor, what: str) -> None:
    """Shared operand contract of B1 and B2: x (m, words*32) bf16/f32,
    packed (r, words) int32, both contiguous and on one device."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: x must be bfloat16 or float32, got {x.dtype}")
    if packed.dtype != torch.int32:
        raise TypeError(f"{what}: packed must be int32, got {packed.dtype}")
    if x.ndim != 2 or packed.ndim != 2:
        raise ValueError(f"{what}: x and packed must be 2-D, got "
                         f"{tuple(x.shape)} and {tuple(packed.shape)}")
    if x.shape[1] != packed.shape[1] * LANE_BITS:
        raise ValueError(f"{what}: x has {x.shape[1]} columns, packed rows "
                         f"cover {packed.shape[1] * LANE_BITS}")
    if x.shape[0] < 1 or packed.shape[0] < 1:
        raise ValueError(f"{what}: empty operand {tuple(x.shape)} / "
                         f"{tuple(packed.shape)}")
    if not (x.is_contiguous() and packed.is_contiguous()):
        raise ValueError(f"{what}: x and packed must be contiguous")
    if x.device != packed.device:
        raise ValueError(f"{what}: x on {x.device}, packed on {packed.device}")


def cuda_args(x: torch.Tensor, packed: torch.Tensor, what: str,
              out_dtype: torch.dtype = torch.float32):
    """Validate the CUDA-side preconditions and allocate the (m, r) output
    of ``out_dtype``; returns (out, stream handle)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    if x.device.index not in (None, torch.cuda.current_device()):
        raise ValueError(f"{what}: x is on {x.device}, the current CUDA "
                         f"device is {torch.cuda.current_device()}")
    if x.data_ptr() % 16 or packed.data_ptr() % 4:
        raise ValueError(f"{what}: x must be 16-byte aligned")
    out = torch.empty((x.shape[0], packed.shape[0]), dtype=out_dtype,
                      device=x.device)
    return out, torch.cuda.current_stream(x.device).cuda_stream


def unpack_rows(packed: torch.Tensor) -> torch.Tensor:
    """(r, words) int32 -> (r, words*32) ±1 float32 (pad bits included)."""
    return unpack_bits(packed, packed.shape[1] * LANE_BITS, dtype=torch.float32)


def tiled_matmul_plain(x: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of B2: unpack to ±1, then x.float() @ t.T."""
    return x.float() @ unpack_rows(packed).T


TILE_M = TILE_N = 64      # the kernel's output tile
MIN_SPLIT_WORDS = 4       # packed words (128 columns) per K split, at least


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_k(m: int, r: int, words: int, sms: int):
    """(splits, words_per_split): enough K splits for about two blocks per
    SM when the (m, r) output has few 64 x 64 tiles, each split covering at
    least MIN_SPLIT_WORDS words; every split is non-empty."""
    tiles = -(-m // TILE_M) * -(-r // TILE_N)
    want = max(1, min(-(-2 * sms // tiles), words // MIN_SPLIT_WORDS))
    per = -(-words // want)
    return -(-words // per), per


@functools.lru_cache(maxsize=None)
def _launcher():
    """(library, bound launch function), built and loaded on first use."""
    lib = _build.load("tiled_matmul")
    fn = lib.tbn_tiled_matmul
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def tiled_matmul_unique(x: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """u = x @ T^T for a row-packed tile: x (m, words*32) bf16/f32, packed
    (r, words) int32 -> (m, r) float32. Launches kernel B2 for CUDA tensors;
    CPU tensors take the plain version."""
    check_operands(x, packed, "tiled_matmul_unique")
    if x.device.type == "cpu":
        return tiled_matmul_plain(x, packed)
    out, stream = cuda_args(x, packed, "tiled_matmul_unique")
    m, (r, words) = x.shape[0], packed.shape
    splits, per = split_k(m, r, words, _sm_count(out.device.index))
    work = (torch.empty((splits, m, r), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    lib, launch = _launcher()
    err = launch(x.data_ptr(), packed.data_ptr(), out.data_ptr(),
                     None if work is None else work.data_ptr(), m, r, words,
                     splits, per, int(x.dtype == torch.bfloat16), stream)
    _build.check(lib, err, "tiled_matmul_unique")
    tiled_matmul_unique.launches += 1
    return out


tiled_matmul_unique.launches = 0
