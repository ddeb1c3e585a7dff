"""Kernel B1: decode-time tiled mat*vec* with a reused packed tile, m <= 32.

Replaces ``repro/kernels/tiled_matvec.py:97`` ``tiled_matvec_unique`` (the
Pallas TPU kernel ``_matvec_kernel`` with ``tiled_matmul._unpack_block``).
The CUDA source is ``csrc/tiled_matvec.cu``; its header says what bounds
the kernel on an H100 (memory and launch: a decode tick reads each tile
word once for a handful of rows) and how the design does one pass over the
packed words with the sign flips done as XORs on the staged activations.

``ops.tiled_dense_infer`` routes every matmul with m <= ``MATVEC_MAX_M``
rows (after flattening lead dims) here: each decode tick, and the extend
tick's LM head on the last valid column of each slot. The wrapper launches
the kernel for CUDA tensors and runs the plain PyTorch version only for CPU
tensors.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.tiled_matmul import check_operands, cuda_args, unpack_rows

# Dispatch threshold: batches at or under this m take the decode kernel.
MATVEC_MAX_M = 32


def tiled_matvec_plain(x: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of B1: unpack to ±1, then x.float() @ t.T."""
    return x.float() @ unpack_rows(packed).T


@functools.lru_cache(maxsize=None)
def _launcher():
    """(library, bound launch function), built and loaded on first use."""
    lib = _build.load("tiled_matvec")
    fn = lib.tbn_tiled_matvec
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def tiled_matvec_unique(x: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """u = x @ T^T at decode-sized m: x (m <= 32, words*32) bf16/f32, packed
    (r, words) int32 -> (m, r) float32. Launches kernel B1 for CUDA tensors;
    CPU tensors take the plain version."""
    check_operands(x, packed, "tiled_matvec_unique")
    if x.shape[0] > MATVEC_MAX_M:
        raise ValueError(f"tiled_matvec_unique: m={x.shape[0]} exceeds "
                         f"MATVEC_MAX_M={MATVEC_MAX_M}")
    if x.device.type == "cpu":
        return tiled_matvec_plain(x, packed)
    out, stream = cuda_args(x, packed, "tiled_matvec_unique")
    lib, launch = _launcher()
    err = launch(x.data_ptr(), packed.data_ptr(), out.data_ptr(),
                     x.shape[0], packed.shape[0], packed.shape[1],
                     int(x.dtype == torch.bfloat16), stream)
    _build.check(lib, err, "tiled_matvec_unique")
    tiled_matvec_unique.launches += 1
    return out


tiled_matvec_unique.launches = 0
