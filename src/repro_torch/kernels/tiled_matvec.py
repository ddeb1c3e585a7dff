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
model; :func:`plan_int8` and :func:`plan_xnor` do the same for kernels B4
and B3 (``tiled_xnor.py``), whose bodies have the same shape (B3's add
their K splits in a thread-block cluster, not by the split pass).

``ops.tiled_dense_infer`` routes every matmul with m <= ``MATVEC_MAX_M``
rows (after flattening lead dims) here: each decode tick, and the extend
tick's LM head on the last valid column of each slot. The wrapper calls
the operator ``repro_torch::tiled_matvec_unique`` (``kernels/_op.py``),
which launches the kernel for CUDA tensors and runs the plain PyTorch
version only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._op import kernel_op
from repro_torch.kernels.tiled_matmul import (
    _sm_count,
    check_operands,
    cuda_args,
    plain_product,
    u_shape,
)

# Dispatch threshold: batches at or under this m take the decode kernel.
MATVEC_MAX_M = 32


def tiled_matvec_plain(x: torch.Tensor, packed: torch.Tensor,
                       plan_shape=None) -> torch.Tensor:
    """The plain PyTorch version of B1: unpack to ±1, then x.float() @ t.T
    (``tiled_matmul.plain_product``: a block of a larger call at its
    offset in it)."""
    return plain_product(x, packed, plan_shape)


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
      x, filter) over the SMs its r / 2 blocks occupy, + ``simt_row_ns``
      per row of x and wave of blocks (B3: each row's cross-lane sum);
    * a tensor-core body: ``call_us`` + whole waves of blocks, each taking
      ``word_ns`` per word of its split and 16-filter group and ``stage_ns``
      per word and n-tile of 8 rows (staging x), plus, when K is split,
      ``split_ns`` per output element and split for the split pass (B1,
      B4: its fixed cost is folded into ``call_us``), or, where the splits
      add their tiles in a cluster (B3), ``cluster_us`` + ``cluster_tile_us``
      per n-tile of 8 rows (the clusters exchange their tiles side by side,
      each as long as its tile is wide)."""
    simt_call_us: float
    simt_ns: float
    call_us: float
    word_ns: float
    stage_ns: float
    split_ns: float = 0.0
    simt_row_ns: float = 0.0
    cluster_us: float = 0.0
    cluster_tile_us: float = 0.0


B1_COST = CostModel(simt_call_us=1.50, simt_ns=1.320, call_us=3.46, word_ns=11.54,
                    stage_ns=13.92, split_ns=0.00459)


@dataclasses.dataclass(frozen=True)
class MatvecPlan:
    """How one B1 / B3 / B4 call runs: the body, its filters per block
    ``bf``, and the K split: ``splits`` ranges of ``per_split`` words, the
    last one shorter (the CUDA-core bodies never split), added by the split
    pass (B1, B4) or, with ``cluster`` (B3), by the splits of a filter tile
    together as one thread-block cluster."""
    body: str
    code: int
    bf: int
    splits: int
    per_split: int
    cluster: bool = False

    @property
    def reduce(self) -> str:
        """How the K splits are added: "none" (one split), "cluster" or
        "pass"."""
        if self.splits == 1:
            return "none"
        return "cluster" if self.cluster else "pass"

    def grid(self, r: int):
        """(x, y) grid of the launch: filter tiles, K splits."""
        return (-(-r // self.bf), self.splits)

    def blocks(self, r: int) -> int:
        x, y = self.grid(r)
        return x * y


def stage_bytes(m: int, bf: int, n: int, word_bytes: int, step: int = 1,
                cluster: bool = False) -> int:
    """Dynamic shared memory of a tensor-core block (csrc decode_mma.cuh
    smem_bytes) for a split of n words, staged in whole steps of ``step``
    words: 8 * ceil(m / 8) rows of x (a pitch of 16 mod 128 bytes) and the
    words of bf filters (an odd pitch for 1-word steps, 4 mod 32 words for
    8-word steps), or the warps' partial sums, whichever is larger, and
    with ``cluster`` the slots of the partial tile that the cluster's
    blocks send to this one."""
    nt, fw = -(-m // 8), bf // 16
    ns = -(-n // step) * step
    pitch = (ns * word_bytes + 127) // 128 * 128 + 16
    wp = (ns | 1) if step == 1 else -(-ns // 32) * 32 + 4
    warps = max(4, fw)
    red = (warps // fw - 1) * fw * 32 * nt * 16
    recv = (fw * nt * 128 + 32 * 8) * 4 if cluster else 0
    return recv + max(8 * nt * pitch + bf * wp * 4, red)


@functools.lru_cache(maxsize=None)
def max_split_words(m: int, bf: int, word_bytes: int, step: int = 1,
                    cluster: bool = False) -> int:
    """The most words (whole steps) a split of a tensor-core block may
    have: what it stages must fit in MAX_SMEM."""
    n = step
    while stage_bytes(m, bf, n + step, word_bytes, step, cluster) <= MAX_SMEM:
        n += step
    return n


def mma_split(tiles: int, words: int, sms: int, cap: int, step: int = 1,
              most: int | None = None):
    """(splits, per_split): the fewest K splits, each a whole number of
    ``step``-word steps, none empty and none over ``cap`` words, that make
    tiles * splits >= sms; one step a split where the steps are fewer than
    that. With ``most``, no more than ``most`` splits (fewer than would
    fill the card), or None where ``cap`` allows no such split."""
    units, ucap = -(-words // step), cap // step
    want = max(-(-sms // tiles), -(-units // ucap))
    if most is not None:
        if -(-units // ucap) > most:
            return None
        per = -(-units // min(want, most))
    else:
        per = -(-units // want)
        while per > 1 and -(-units // per) < want:
            per -= 1
    return -(-units // per), per * step


def matvec_plan(bodies, body: str, m: int, r: int, words: int, sms: int,
                word_bytes: int, step: int = 1, cluster: int = 0):
    """``body``'s plan; ``word_bytes``: bytes of an x row a packed word
    covers (B1 bf16: 64, B3 sign words: 4, B4 int8: 32), ``step``: words a
    tensor-core step takes (B3: 8). With ``cluster`` (the most blocks of a
    cluster), the plan whose splits add their tiles in a cluster, or None
    where K cannot be split that few times."""
    code, bf = bodies[body]
    if code == 0:
        return MatvecPlan(body, code, bf, 1, words)
    cap = max_split_words(m, bf, word_bytes, step, bool(cluster))
    split = mma_split(-(-r // bf), words, sms, cap, step, cluster or None)
    if split is None:
        return None
    return MatvecPlan(body, code, bf, *split, cluster=bool(cluster) and split[0] > 1)


def matvec_cost(plan: MatvecPlan, cost: CostModel, m: int, r: int, words: int,
                sms: int) -> float:
    """Modelled time (us) of a plan (see :class:`CostModel`)."""
    if plan.code == 0:
        active = min(sms, plan.blocks(r))
        return (cost.simt_call_us + cost.simt_ns * m * r * words / active / 1e3
                + cost.simt_row_ns * m * -(-plan.blocks(r) // sms) / 1e3)
    waves = -(-plan.blocks(r) // sms)
    t = cost.call_us + waves * plan.per_split * (
        plan.bf // 16 * cost.word_ns + -(-m // 8) * cost.stage_ns) / 1e3
    if plan.cluster:
        t += cost.cluster_us + cost.cluster_tile_us * -(-m // 8)
    elif plan.splits > 1:
        t += cost.split_ns * plan.splits * m * r / 1e3
    return t


def best_matvec_plan(bodies, names, cost: CostModel, m: int, r: int, words: int,
                     sms: int, word_bytes: int) -> MatvecPlan:
    """The plan of least modelled time among ``names`` (first on a tie)."""
    return min((matvec_plan(bodies, b, m, r, words, sms, word_bytes) for b in names),
               key=lambda p: matvec_cost(p, cost, m, r, words, sms))


@functools.lru_cache(maxsize=None)
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


def tiled_matvec_unique(x: torch.Tensor, packed: torch.Tensor,
                        plan_shape=None) -> torch.Tensor:
    """u = x @ T^T at decode-sized m: x (m <= 32, words*32) bf16/f32, packed
    (r, words) int32 -> (m, r) float32. Launches kernel B1 for CUDA tensors
    as :func:`plan_matvec` plans it for (m, r), or for ``plan_shape`` (M, R,
    row0, col0): a rank of a mesh that holds the (m, r) block at (row0,
    col0) of an (M, R) call plans as one card would for the whole, so its
    elements are summed in that card's order, bit for bit. CPU tensors
    take the plain version, which places the block at its offset for the
    same reason."""
    check_operands(x, packed, "tiled_matvec_unique")
    _check_m(x, "tiled_matvec_unique")
    return _matvec_op(x, packed, None if plan_shape is None else list(plan_shape))


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


def _launch(x: torch.Tensor, packed: torch.Tensor, body,
            plan_shape=None) -> torch.Tensor:
    out, stream = cuda_args(x, packed, "tiled_matvec_unique")
    m, (r, words) = x.shape[0], packed.shape
    bf16 = x.dtype == torch.bfloat16
    pm, pr = plan_shape[:2] if plan_shape else (m, r)
    plan = plan_matvec(pm, pr, words, _sm_count(out.device.index), bf16, body)
    work = (torch.empty((plan.splits, m, r), dtype=torch.float32,
                        device=x.device) if plan.splits > 1 else None)
    lib, launch = _launcher()
    err = launch(x.data_ptr(), packed.data_ptr(), out.data_ptr(),
                 None if work is None else work.data_ptr(), m, r, words,
                 int(bf16), plan.code, plan.splits, plan.per_split, stream)
    _build.check(lib, err, "tiled_matvec_unique")
    tiled_matvec_unique.launches += 1
    return out


_matvec_op = kernel_op(
    "tiled_matvec_unique", "(Tensor x, Tensor packed, int[]? plan_shape) -> Tensor",
    lambda x, packed, plan_shape: _launch(x, packed, None, plan_shape),
    lambda x, packed, plan_shape: tiled_matvec_plain(x, packed, plan_shape),
    lambda x, packed, plan_shape: u_shape(x, packed))
tiled_matvec_unique.launches = 0
