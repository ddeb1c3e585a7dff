"""Kernels B3 and B4: integer-domain decode matvec on packed tile words.

Port of ``repro/kernels/tiled_xnor.py``. The float kernels (B1/B2) unpack
every tile word to ±1 and multiply floats; these two paths quantize the
activations too and accumulate integers directly against the packed
``(r, ceil(n_in/32))`` tile words (``ops.tiled_dense_infer`` routes decode
batches, m <= ``MATVEC_MAX_M``, here when ``compute_path`` is not "float"):

* ``xnor`` (B3, replaces ``tiled_xnor.py:147`` ``tiled_xnor_matvec_unique``;
  CUDA source ``csrc/tiled_xnor.cu``) — sign-pack the activations in the
  tile's word layout and compute ``acc = n_in - 2 * sum_w popcount(x_w XOR
  t_w)``: ``__popc`` on CUDA cores, or the 1-bit ``mma.sync`` m16n8k256
  AND-popcount on the tensor cores with the popcounts of x and of the tile
  folded in, as :func:`plan_xnor` picks. Pad bits are 0 on both operands,
  so they never contribute.
* ``int8`` (B4, replaces ``tiled_xnor.py:235`` ``tiled_int8_matvec_unique``;
  CUDA source ``csrc/tiled_int8.cu``) — per-row symmetric int8 activations
  against the ±1 tile with int8 x int8 -> int32 dot products: ``dp4a`` on
  CUDA cores, or ``mma.sync`` m16n8k32 s8 on the tensor cores with the ±1
  bytes built in registers, as :func:`plan_int8` picks. Pad columns of q
  are zero, so pad bits never contribute.

Both return the exact int32 accumulator; ``ops`` applies the activation
scale and the alpha broadcast. The quantizers are plain PyTorch, as the
reference computes them outside Pallas. Each wrapper launches its kernel
for CUDA tensors and runs its plain version only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.core.packing import LANE_BITS, pack_bits, unpack_bits
from repro_torch.kernels import _build
from repro_torch.kernels.tiled_matmul import _sm_count, cuda_args
from repro_torch.kernels.tiled_matvec import (
    MATVEC_MAX_M,
    CostModel,
    MatvecPlan,
    best_matvec_plan,
    matvec_cost,
    matvec_plan,
    max_split_words,
)

COMPUTE_PATHS = ("float", "int8", "xnor")


# --------------------------------------------------------------------------
# Activation quantization
# --------------------------------------------------------------------------
def quantize_sign(x: torch.Tensor, n_in: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sign-binarize activation rows: x (m, k >= n_in) -> (packed (m,
    ceil(n_in/32)) int32, scale (m, 1) f32). Bit j of word w is
    ``x[:, 32w + j] > 0`` (the tile's little-endian layout, pad bits 0);
    ``scale = mean|x_row|``. x is cast to f32 first, as the reference does."""
    xv = x[:, :n_in].float()
    scale = xv.abs().mean(dim=1, keepdim=True)
    return pack_bits(xv > 0), scale


def quantize_int8(x: torch.Tensor, n_in: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: x (m, k >= n_in) -> (q (m, n_in) int8 in
    [-127, 127], scale (m, 1) f32) with x ~= q * scale; an all-zero row gets
    scale 1. ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    xv = x[:, :n_in].float()
    amax = xv.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xv / scale), -127, 127).to(torch.int8)
    return q, scale


def popcount32(v: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of each 32-bit word -> int32 counts. torch's ``>>`` on
    int32 is arithmetic, so the steps run in int64 on the word's unsigned
    value (``& 0xFFFFFFFF``), where every shift brings in zeros."""
    v = v.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = (v + (v >> 8) + (v >> 16) + (v >> 24)) & 0x3F
    return v.to(torch.int32)


# --------------------------------------------------------------------------
# Plain versions (the structured twins of the reference)
# --------------------------------------------------------------------------
def xnor_matvec_words(packed_x: torch.Tensor, packed_rows: torch.Tensor, *,
                      n_in: int) -> torch.Tensor:
    """The plain PyTorch version of B3: (m, W) x (r, W) int32 words ->
    (m, r) int32 ``n_in - 2 * sum_w popcount(x XOR t)``."""
    xo = torch.bitwise_xor(packed_x[:, None, :], packed_rows[None, :, :])
    return (n_in - 2 * popcount32(xo).sum(dim=-1)).to(torch.int32)


def int8_matvec_packed(q: torch.Tensor, packed_rows: torch.Tensor, *,
                       n_in: int) -> torch.Tensor:
    """The plain PyTorch version of B4: q (m, >= n_in) int8 against the
    {0, 1} tile bits, folded to the ±1 dot as ``2 * (q @ bits^T) -
    rowsum(q)`` -> (m, r) int32. torch has no integer matmul on CUDA, so the
    product runs in float64, exact here: every partial sum is an integer of
    magnitude at most 127 * n_in, far below 2**53."""
    bits = (unpack_bits(packed_rows, n_in, dtype=torch.float64) + 1) / 2
    qv = q[:, :n_in].double()
    s1 = qv @ bits.T
    return (2 * s1 - qv.sum(dim=1, keepdim=True)).to(torch.int32)


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------
def _check(a: torch.Tensor, packed: torch.Tensor, dtype: torch.dtype,
           cols: int, what: str) -> None:
    """Operand contract shared by B3 and B4: a (m <= MATVEC_MAX_M, cols) of
    ``dtype``, packed (r, words) int32, both 2-D, contiguous, one device."""
    if a.dtype != dtype or packed.dtype != torch.int32:
        raise TypeError(f"{what}: expected {dtype} activations and int32 "
                        f"words, got {a.dtype} and {packed.dtype}")
    if a.ndim != 2 or packed.ndim != 2:
        raise ValueError(f"{what}: operands must be 2-D, got "
                         f"{tuple(a.shape)} and {tuple(packed.shape)}")
    if a.shape[1] != cols:
        raise ValueError(f"{what}: activations have {a.shape[1]} columns, "
                         f"packed rows of {packed.shape[1]} words need {cols}")
    if a.shape[0] < 1 or packed.shape[0] < 1 or packed.shape[1] < 1:
        raise ValueError(f"{what}: empty operand {tuple(a.shape)} / "
                         f"{tuple(packed.shape)}")
    if a.shape[0] > MATVEC_MAX_M:
        raise ValueError(f"{what}: m={a.shape[0]} exceeds "
                         f"MATVEC_MAX_M={MATVEC_MAX_M}")
    if not (a.is_contiguous() and packed.is_contiguous()):
        raise ValueError(f"{what}: operands must be contiguous")
    if a.device != packed.device:
        raise ValueError(f"{what}: operands on {a.device} and {packed.device}")


@functools.lru_cache(maxsize=None)
def _launcher(name: str, symbol: str, n_ptrs: int, n_ints: int):
    """(library, bound launch function): ``n_ptrs`` pointers, ``n_ints``
    ints and the stream; built and loaded on first use."""
    lib = _build.load(name)
    fn = getattr(lib, symbol)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


# body -> (C id, filters per block) of B4: "dp4a" on CUDA cores (two
# filters a block, no K split), the others mma.sync s8 (csrc/tiled_int8.cu)
INT8_BODIES = {"dp4a": (0, 2), "mma16": (1, 16), "mma32": (2, 32),
               "mma64": (3, 64), "mma128": (4, 128)}
# B4's cost model (see tiled_matvec.CostModel), fitted to chip_smoke.py's
# body survey on an H100 SXM (PERF.md §6)
B4_COST = CostModel(simt_call_us=1.41, simt_ns=0.483, call_us=3.43, word_ns=8.25,
                    stage_ns=5.71, split_ns=0.00402)


@functools.lru_cache(maxsize=None)
def plan_int8(m: int, r: int, words: int, sms: int,
              body: str | None = None) -> MatvecPlan:
    """The plan of one B4 call on a card with ``sms`` SMs: the body of
    least modelled time (``body`` forces one; the card tests run each).
    Cached: a pure function of its arguments, asked on every launch."""
    return best_matvec_plan(INT8_BODIES, [body] if body else INT8_BODIES,
                            B4_COST, m, r, words, sms, 32)


# body -> (C id, filters per block) of B3: "popc" on CUDA cores (two
# filters a block, no K split), the others the 1-bit mma.sync m16n8k256
# (csrc/tiled_xnor.cu), whose splits are whole steps of XNOR_STEP words.
# XNOR_REDUCE: K whole in each block ("none"), or split at most
# XNOR_CLUSTER times and added in a thread-block cluster ("cluster")
XNOR_BODIES = {"popc": (0, 2), "bmma16": (1, 16), "bmma32": (2, 32),
               "bmma64": (3, 64), "bmma128": (4, 128)}
XNOR_STEP, XNOR_CLUSTER = 8, 8
XNOR_REDUCE = ("none", "cluster")
# The planner offers "popc" up to this m: from its 16-row template on, its
# rows' cross-lane sums cost more than a tensor-core body at every
# main-path shape (PERF.md §6), in a step the cost model's per-row term
# does not follow. Past it "popc" is only the fallback for a K too long for
# every tensor-core plan.
XNOR_POPC_MAX_M = 8
# B3's cost model, fitted to chip_smoke.py's body survey on an H100 SXM
# (PERF.md §6)
B3_COST = CostModel(simt_call_us=1.35, simt_ns=0.0786, simt_row_ns=17.6, call_us=1.856,
                    word_ns=2.247, stage_ns=1.884, cluster_us=0.520, cluster_tile_us=0.242)


def xnor_plans(m: int, r: int, words: int, sms: int, body: str):
    """Every plan of ``body`` for one B3 call: the CUDA-core body's one, or
    a tensor-core body's plans by XNOR_REDUCE: K whole (where it fits in
    shared memory) and K split, few enough times for a cluster, until a
    wave of blocks runs (where K has more than one step)."""
    code, bf = XNOR_BODIES[body]
    if code == 0:
        return [matvec_plan(XNOR_BODIES, body, m, r, words, sms, 4)]
    plans = []
    if words <= max_split_words(m, bf, 4, XNOR_STEP):
        plans.append(MatvecPlan(body, code, bf, 1, words))
    plan = matvec_plan(XNOR_BODIES, body, m, r, words, sms, 4, XNOR_STEP, XNOR_CLUSTER)
    if plan is not None and plan.splits > 1:
        plans.append(plan)
    return plans


@functools.lru_cache(maxsize=None)
def plan_xnor(m: int, r: int, words: int, sms: int, body: str | None = None,
              reduce: str | None = None) -> MatvecPlan:
    """The plan of one B3 call on a card with ``sms`` SMs: the body and
    split reduction of least modelled time (first on a tie; ``body`` and
    ``reduce`` force them, for the card tests and the body survey), and
    "popc" where no tensor-core plan fits. Cached: a pure function of its
    arguments, asked on every launch."""
    names = [body] if body else [b for b in XNOR_BODIES
                                 if b != "popc" or m <= XNOR_POPC_MAX_M]
    plans = [p for b in names for p in xnor_plans(m, r, words, sms, b)
             if reduce is None or p.code == 0 or p.reduce == reduce]
    if not plans and body is None:
        plans = xnor_plans(m, r, words, sms, "popc")
    if not plans:
        raise ValueError(f"plan_xnor: body {body!r} has no {reduce} plan at m={m}, "
                         f"r={r}, words={words}")
    return min(plans, key=lambda p: matvec_cost(p, B3_COST, m, r, words, sms))


def tiled_xnor_matvec_unique(packed_x: torch.Tensor, packed_rows: torch.Tensor,
                             *, n_in: int) -> torch.Tensor:
    """acc = sign(x) . T^T in the integer domain: packed_x (m <= 32, W)
    int32 sign-packed activations, packed_rows (r, W) int32, pad bits 0 on
    both -> (m, r) int32. Launches kernel B3 for CUDA tensors as
    :func:`plan_xnor` plans it; CPU tensors take the plain version."""
    what = "tiled_xnor_matvec_unique"
    _check_xnor(packed_x, packed_rows, n_in, what)
    if packed_x.device.type == "cpu":
        return xnor_matvec_words(packed_x, packed_rows, n_in=n_in)
    return _launch_xnor(packed_x, packed_rows, n_in, None, None)


def tiled_xnor_body(packed_x: torch.Tensor, packed_rows: torch.Tensor, body: str,
                    *, n_in: int, reduce: str | None = None) -> torch.Tensor:
    """Kernel B3 on CUDA tensors with ``body`` (and the split reduction,
    ``reduce``: one of XNOR_REDUCE) forced in place of the planner's pick:
    the card checks hold every body against the plain version and time it
    beside the cost model."""
    what = "tiled_xnor_body"
    _check_xnor(packed_x, packed_rows, n_in, what)
    if body not in XNOR_BODIES or reduce not in (None, *XNOR_REDUCE):
        raise ValueError(f"{what}: body {body!r}, reduce {reduce!r}; expected one "
                         f"of {sorted(XNOR_BODIES)} and of {XNOR_REDUCE}")
    return _launch_xnor(packed_x, packed_rows, n_in, body, reduce)


def _check_xnor(packed_x, packed_rows, n_in: int, what: str) -> None:
    words = packed_rows.shape[1] if packed_rows.ndim == 2 else 0
    _check(packed_x, packed_rows, torch.int32, words, what)
    if not 0 < n_in <= words * LANE_BITS:
        raise ValueError(f"{what}: n_in={n_in} outside the {words} words")


def _launch_xnor(packed_x: torch.Tensor, packed_rows: torch.Tensor, n_in: int,
                 body, reduce) -> torch.Tensor:
    what = "tiled_xnor_matvec_unique"
    out, stream = cuda_args(packed_x, packed_rows, what, torch.int32)
    m, (r, words) = packed_x.shape[0], packed_rows.shape
    plan = plan_xnor(m, r, words, _sm_count(out.device.index), body, reduce)
    lib, launch = _launcher("tiled_xnor", "tbn_tiled_xnor", 3, 7)
    err = launch(packed_x.data_ptr(), packed_rows.data_ptr(), out.data_ptr(), m, r,
                 words, n_in, plan.code, plan.splits, plan.per_split, stream)
    _build.check(lib, err, what)
    tiled_xnor_matvec_unique.launches += 1
    return out


def tiled_int8_matvec_unique(q: torch.Tensor, packed_rows: torch.Tensor
                             ) -> torch.Tensor:
    """acc = q . T^T with int8 activations and ±1 weights: q (m <= 32, W*32)
    int8 with zero pad columns, packed_rows (r, W) int32 -> (m, r) int32.
    Launches kernel B4 for CUDA tensors as :func:`plan_int8` plans it; CPU
    tensors take the plain version."""
    what = "tiled_int8_matvec_unique"
    words = packed_rows.shape[1] if packed_rows.ndim == 2 else 0
    _check(q, packed_rows, torch.int8, words * LANE_BITS, what)
    if q.device.type == "cpu":
        return int8_matvec_packed(q, packed_rows, n_in=q.shape[1])
    return _launch_int8(q, packed_rows, None)


def tiled_int8_body(q: torch.Tensor, packed_rows: torch.Tensor,
                    body: str) -> torch.Tensor:
    """Kernel B4 on CUDA tensors with ``body`` forced in place of the
    planner's pick: the card checks hold every body against the plain
    version and time it beside the cost model."""
    what = "tiled_int8_body"
    words = packed_rows.shape[1] if packed_rows.ndim == 2 else 0
    _check(q, packed_rows, torch.int8, words * LANE_BITS, what)
    if body not in INT8_BODIES:
        raise ValueError(f"{what}: body {body!r}; expected one of "
                         f"{sorted(INT8_BODIES)}")
    return _launch_int8(q, packed_rows, body)


def _launch_int8(q: torch.Tensor, packed_rows: torch.Tensor, body
                 ) -> torch.Tensor:
    what = "tiled_int8_matvec_unique"
    out, stream = cuda_args(q, packed_rows, what, torch.int32)
    m, (r, words) = q.shape[0], packed_rows.shape
    plan = plan_int8(m, r, words, _sm_count(out.device.index), body)
    work = (torch.empty((plan.splits, m, r), dtype=torch.int32,
                        device=q.device) if plan.splits > 1 else None)
    lib, launch = _launcher("tiled_int8", "tbn_tiled_int8", 4, 6)
    err = launch(q.data_ptr(), packed_rows.data_ptr(), out.data_ptr(),
                 None if work is None else work.data_ptr(), m, r, words,
                 plan.code, plan.splits, plan.per_split, stream)
    _build.check(lib, err, what)
    tiled_int8_matvec_unique.launches += 1
    return out


tiled_xnor_matvec_unique.launches = 0
tiled_int8_matvec_unique.launches = 0
