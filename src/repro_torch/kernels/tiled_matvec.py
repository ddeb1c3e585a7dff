"""Kernel B1: decode-time tiled mat*vec* with a reused packed tile, m <= 32.

Replaces ``repro/kernels/tiled_matvec.py:97`` ``tiled_matvec_unique`` (the
Pallas TPU kernel ``_matvec_kernel`` with ``tiled_matmul._unpack_block``).
The CUDA source is ``csrc/tiled_matvec.cu``; its header says what bounds
the kernel on an H100 (memory and launch: a decode tick reads each tile
word once for a handful of rows) and its two bodies: "simt", CUDA cores
with the sign flips done as XORs, and the tensor-core bodies "mma16" /
"mma32" / "mma64" (bf16 only), ``mma.sync`` m16n8k16 with the ±1 tile
built in registers and x staged once per block, K split over blocks.

:func:`plan_matvec` picks the body and the K split on the host with a cost
model; :func:`plan_int8` does the same for kernel B4 (``tiled_xnor.py``),
whose bodies have the same shape.

``ops.tiled_dense_infer`` routes every matmul with m <= ``MATVEC_MAX_M``
rows (after flattening lead dims) here: each decode tick, and the extend
tick's LM head on the last valid column of each slot. The wrapper launches
the kernel for CUDA tensors and runs the plain PyTorch version only for CPU
tensors.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.tiled_matmul import (
    _sm_count,
    check_operands,
    cuda_args,
    unpack_rows,
)

# Dispatch threshold: batches at or under this m take the decode kernel.
MATVEC_MAX_M = 32


def tiled_matvec_plain(x: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of B1: unpack to ±1, then x.float() @ t.T."""
    return x.float() @ unpack_rows(packed).T


# ----------------------------------------------------------------- planner
MAX_SMEM = 96 * 1024      # dynamic shared memory a block may take (csrc
                          # decode_mma.cuh kMaxSmem)
# body -> (C id, filters per block); "simt" is B1's CUDA-core body (two
# filters a block, no K split), the others the tensor-core body
MV_BODIES = {"simt": (0, 2), "mma16": (1, 16), "mma32": (2, 32), "mma64": (3, 64),
             "mma128": (4, 128)}


@dataclasses.dataclass(frozen=True)
class CostModel:
    """A matvec kernel's modelled time (us), fitted (least relative squares,
    ``python -m repro_torch.kernels.fit_matvec_cost``) to the body survey of
    ``chip_smoke.py`` on an H100 SXM (PERF.md §6):

    * the CUDA-core body: ``simt_call_us`` + ``simt_ns`` per (word, row of
      x, filter) over the SMs its r / 2 blocks occupy;
    * a tensor-core body: ``call_us`` + whole waves of blocks, each taking
      ``word_ns`` per word of its split and 16-filter group and ``stage_ns``
      per word and n-tile of 8 rows (staging x), plus ``split_ns`` per
      output element and split for the split pass when K is split."""
    simt_call_us: float
    simt_ns: float
    call_us: float
    word_ns: float
    stage_ns: float
    split_ns: float


B1_COST = CostModel(simt_call_us=1.50, simt_ns=1.320, call_us=3.46, word_ns=11.54,
                    stage_ns=13.92, split_ns=0.00459)


@dataclasses.dataclass(frozen=True)
class MatvecPlan:
    """How one B1 / B4 call runs: the body, its filters per block ``bf``,
    and the K split: ``splits`` ranges of ``per_split`` words, the last one
    shorter (the CUDA-core bodies never split)."""
    body: str
    code: int
    bf: int
    splits: int
    per_split: int

    def grid(self, r: int):
        """(x, y) grid of the launch: filter tiles, K splits."""
        return (-(-r // self.bf), self.splits)

    def blocks(self, r: int) -> int:
        x, y = self.grid(r)
        return x * y


def stage_bytes(m: int, bf: int, n: int, word_bytes: int) -> int:
    """Dynamic shared memory of a tensor-core block (csrc decode_mma.cuh
    smem_bytes) for a split of n words: 8 * ceil(m / 8) rows of x (a pitch
    of 16 mod 128 bytes) and the odd-pitched words of bf filters, or the
    warps' partial sums, whichever is larger."""
    nt, fw = -(-m // 8), bf // 16
    pitch = (n * word_bytes + 127) // 128 * 128 + 16
    warps = max(4, fw)
    return max(8 * nt * pitch + bf * (n | 1) * 4, (warps // fw - 1) * fw * 32 * nt * 16)


@functools.lru_cache(maxsize=None)
def max_split_words(m: int, bf: int, word_bytes: int) -> int:
    """The most words a split of a tensor-core block may have: what it
    stages must fit in MAX_SMEM."""
    n = 1
    while stage_bytes(m, bf, n + 1, word_bytes) <= MAX_SMEM:
        n += 1
    return n


def mma_split(tiles: int, words: int, sms: int, cap: int):
    """(splits, per_split): the fewest K splits, each a whole number of
    words, none empty and none over ``cap`` words, that make tiles * splits
    >= sms; one word a split where the words are fewer than that."""
    want = max(-(-sms // tiles), -(-words // cap))
    per = -(-words // want)
    while per > 1 and -(-words // per) < want:
        per -= 1
    return -(-words // per), per


def matvec_plan(bodies, body: str, m: int, r: int, words: int, sms: int,
                word_bytes: int) -> MatvecPlan:
    """``body``'s plan; ``word_bytes``: bytes of an x row a packed word
    covers (B1 bf16: 64, B4 int8: 32)."""
    code, bf = bodies[body]
    if code == 0:
        return MatvecPlan(body, code, bf, 1, words)
    cap = max_split_words(m, bf, word_bytes)
    return MatvecPlan(body, code, bf, *mma_split(-(-r // bf), words, sms, cap))


def matvec_cost(plan: MatvecPlan, cost: CostModel, m: int, r: int, words: int,
                sms: int) -> float:
    """Modelled time (us) of a plan (see :class:`CostModel`)."""
    if plan.code == 0:
        active = min(sms, plan.blocks(r))
        return cost.simt_call_us + cost.simt_ns * m * r * words / active / 1e3
    waves = -(-plan.blocks(r) // sms)
    t = cost.call_us + waves * plan.per_split * (
        plan.bf // 16 * cost.word_ns + -(-m // 8) * cost.stage_ns) / 1e3
    if plan.splits > 1:
        t += cost.split_ns * plan.splits * m * r / 1e3
    return t


def best_matvec_plan(bodies, names, cost: CostModel, m: int, r: int, words: int,
                     sms: int, word_bytes: int) -> MatvecPlan:
    """The plan of least modelled time among ``names`` (first on a tie)."""
    return min((matvec_plan(bodies, b, m, r, words, sms, word_bytes) for b in names),
               key=lambda p: matvec_cost(p, cost, m, r, words, sms))


def plan_matvec(m: int, r: int, words: int, sms: int, bf16: bool = True,
                body: str | None = None) -> MatvecPlan:
    """The plan of one B1 call on a card with ``sms`` SMs: f32 x takes the
    CUDA-core body, bf16 the body of least modelled time (``body`` forces
    one; the card tests run each)."""
    if not bf16:
        return matvec_plan(MV_BODIES, "simt", m, r, words, sms, 128)
    return best_matvec_plan(MV_BODIES, [body] if body else MV_BODIES, B1_COST,
                            m, r, words, sms, 64)


@functools.lru_cache(maxsize=None)
def _launcher():
    """(library, bound launch function), built and loaded on first use."""
    lib = _build.load("tiled_matvec")
    fn = lib.tbn_tiled_matvec
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def _check_m(x: torch.Tensor, what: str) -> None:
    if x.shape[0] > MATVEC_MAX_M:
        raise ValueError(f"{what}: m={x.shape[0]} exceeds "
                         f"MATVEC_MAX_M={MATVEC_MAX_M}")


def tiled_matvec_unique(x: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """u = x @ T^T at decode-sized m: x (m <= 32, words*32) bf16/f32, packed
    (r, words) int32 -> (m, r) float32. Launches kernel B1 for CUDA tensors
    as :func:`plan_matvec` plans it; CPU tensors take the plain version."""
    check_operands(x, packed, "tiled_matvec_unique")
    _check_m(x, "tiled_matvec_unique")
    if x.device.type == "cpu":
        return tiled_matvec_plain(x, packed)
    return _launch(x, packed, None)


def tiled_matvec_body(x: torch.Tensor, packed: torch.Tensor,
                      body: str) -> torch.Tensor:
    """Kernel B1 on CUDA tensors with ``body`` forced in place of the
    planner's pick (bf16: any of MV_BODIES; f32: "simt" only): the card
    checks hold every body against the plain version and time it beside
    the cost model."""
    check_operands(x, packed, "tiled_matvec_body")
    _check_m(x, "tiled_matvec_body")
    if body not in MV_BODIES or (x.dtype != torch.bfloat16 and body != "simt"):
        raise ValueError(f"tiled_matvec_body: body {body!r} on {x.dtype} x; "
                         f"expected one of {sorted(MV_BODIES)} (bfloat16) or "
                         f"'simt'")
    return _launch(x, packed, body)


def _launch(x: torch.Tensor, packed: torch.Tensor, body) -> torch.Tensor:
    out, stream = cuda_args(x, packed, "tiled_matvec_unique")
    m, (r, words) = x.shape[0], packed.shape
    bf16 = x.dtype == torch.bfloat16
    plan = plan_matvec(m, r, words, _sm_count(out.device.index), bf16, body)
    work = (torch.empty((plan.splits, m, r), dtype=torch.float32,
                        device=x.device) if plan.splits > 1 else None)
    lib, launch = _launcher()
    err = launch(x.data_ptr(), packed.data_ptr(), out.data_ptr(),
                 None if work is None else work.data_ptr(), m, r, words,
                 int(bf16), plan.code, plan.splits, plan.per_split, stream)
    _build.check(lib, err, "tiled_matvec_unique")
    tiled_matvec_unique.launches += 1
    return out


tiled_matvec_unique.launches = 0
