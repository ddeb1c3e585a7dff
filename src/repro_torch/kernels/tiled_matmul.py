"""Kernel B2: fully-connected forward with a reused bit-packed tile, any m.

Replaces ``repro/kernels/tiled_matmul.py:69`` ``tiled_matmul_unique`` (the
Pallas TPU kernel ``_matmul_kernel`` with ``_unpack_block``). The CUDA
source is ``csrc/tiled_matmul.cu`` with the Hopper mainloop it shares with
B6 in ``csrc/hopper_gemm.cuh``; its header says what bounds the kernel on
an H100 (operations: chunked prefill runs m = n_slots * chunk_tokens rows,
the fused train step m = B*S) and how the design keeps the dense ±1 weight
out of device memory and the tensor cores fed.

:func:`plan_matmul` picks the body, its tile and the K split on the host.

The wrapper checks the operands and calls the operator
``repro_torch::tiled_matmul_unique`` (``kernels/_op.py``), which launches
the kernel for CUDA tensors and runs the plain PyTorch version (unpack to
±1, ``x.float() @ t.T``) only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core.packing import LANE_BITS, unpack_bits
from repro_torch.kernels import _build
from repro_torch.kernels._op import kernel_op

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


def plain_product(x: torch.Tensor, packed: torch.Tensor, plan_shape=None
                  ) -> torch.Tensor:
    """x.float() @ T^T (m, r) against the ±1 rows of ``packed``: the plain
    versions of B1 and B2. With ``plan_shape`` (M, R, row0, col0), a
    rank's block at (row0, col0) of an (M, R) call, the product runs over
    the whole (M, R) with the block at its offset and zeros around it, so
    the host's BLAS sums each of the block's elements as it sums the whole
    call's: bit for bit one device's."""
    t = unpack_rows(packed)
    m, r = x.shape[0], t.shape[0]
    if plan_shape is None or len(plan_shape) < 4 or tuple(plan_shape[:2]) == (m, r):
        return x.float() @ t.T
    pm, pr, row0, col0 = plan_shape
    xw = x.new_zeros((pm, x.shape[1]), dtype=torch.float32)
    xw[row0:row0 + m] = x.float()
    tw = t.new_zeros((pr, t.shape[1]))
    tw[col0:col0 + r] = t
    return (xw @ tw.T)[row0:row0 + m, col0:col0 + r].contiguous()


def tiled_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                       plan_shape=None) -> torch.Tensor:
    """The plain PyTorch version of B2: unpack to ±1, then x.float() @ t.T
    (``plain_product``: a block of a larger call at its offset in it)."""
    return plain_product(x, packed, plan_shape)


TILE_M = TILE_N = 64      # the f32 FMA body's output tile
MIN_SPLIT_WORDS = 4       # packed words (128 columns) per K split, at least


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_k(m: int, r: int, words: int, sms: int):
    """(splits, words_per_split) of the f32 FMA body's 64 x 64 tiles:
    enough K splits for about two blocks per SM when the (m, r) output has
    few tiles, each split covering at least MIN_SPLIT_WORDS words; every
    split is non-empty."""
    tiles = -(-m // TILE_M) * -(-r // TILE_N)
    want = max(1, min(-(-2 * sms // tiles), words // MIN_SPLIT_WORDS))
    per = -(-words // want)
    return -(-words // per), per


# ---------------------------------------------------------- Hopper planner
STAGE_WORDS = 2           # packed words per K stage of the Hopper body
RING_STAGES = 6           # hopper_gemm.cuh kStages
SMEM_BYTES = 232_448      # shared memory a block may use on an H100
MIN_SPLIT_STAGES = 4      # K stages (256 columns) per split, at least
# bf16 bodies: name -> (C id, filters per tile, rows per tile)
BODIES = {"wg128x64": (0, 128, 64), "wg128x128": (1, 128, 128),
          "wg256x128": (2, 256, 128), "wg128x256": (3, 128, 256)}
# The planner's cost model, fitted to chip_smoke.py's body survey on an
# H100 SXM (PERF.md §6): a body's time per K stage of one tile in steady
# state (us), the fixed cost of a call (launch, pipeline fill, epilogue;
# us), and the split pass's rate (bytes read and written per us).
STAGE_US = {"wg128x64": 0.37, "wg128x128": 0.51, "wg256x128": 0.85,
            "wg128x256": 0.74}
CALL_US = 4.0
PASS_BYTES_PER_US = 2.5e6


def ring_smem(body: str) -> int:
    """Dynamic shared memory of a Hopper body: the ring (x tiles, and a
    word tile per pair of stages) or the f32 epilogue tile that reuses it,
    whichever is larger, plus 1 KB to align the ring to 1024 bytes."""
    _, bm, bn = BODIES[body]
    ring = RING_STAGES * bn * 128 + RING_STAGES // 2 * bm * 2 * STAGE_WORDS * 4
    return max(ring, bn * (bm + 4) * 4) + 1024


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call runs: the body ("fma" for f32 x), its tile (bm filters
    by bn rows), and the K split over ``units`` (words or conv steps for
    "fma", stages of STAGE_WORDS words for the Hopper bodies): ``splits``
    ranges of ``per_split`` units, the last one shorter."""
    body: str
    bm: int
    bn: int
    units: int
    splits: int
    per_split: int

    @property
    def code(self) -> int:
        """The body's id in the C entry points (f32 ignores it)."""
        return BODIES[self.body][0] if self.body in BODIES else 0

    def grid(self, m: int, r: int):
        """(x, y, z) grid of the launch: row tiles, filter tiles, splits
        (the FMA body puts filter tiles on x)."""
        if self.body == "fma":
            return (-(-r // self.bn), -(-m // self.bm), self.splits)
        return (-(-m // self.bn), -(-r // self.bm), self.splits)


def hopper_split(tiles: int, stages: int, sms: int):
    """(splits, per_split): split K only where the grid has fewer tiles
    than SMs, at most up to one wave, each split MIN_SPLIT_STAGES stages or
    more and an even number of them (stages come in pairs that share a word
    tile); every split non-empty."""
    want = max(1, min(sms // tiles, stages // MIN_SPLIT_STAGES))
    if want == 1:
        return 1, stages
    per = -(-stages // want)
    per += per % 2
    return -(-stages // per), per


def hopper_plan(body: str, m: int, r: int, stages: int, sms: int) -> Plan:
    """``body``'s tile and K split for m rows (pixels) by r filters."""
    _, bm, bn = BODIES[body]
    tiles = -(-m // bn) * -(-r // bm)
    return Plan(body, bm, bn, stages, *hopper_split(tiles, stages, sms))


def plan_cost(plan: Plan, m: int, r: int, sms: int) -> float:
    """Modelled time (us) of a Hopper plan: whole waves of blocks, each
    running its K stages, plus the fixed cost of a call and, for a split,
    the pass that reads the slices and writes out."""
    x, y, z = plan.grid(m, r)
    waves = -(-(x * y * z) // sms)
    t = waves * plan.per_split * STAGE_US[plan.body] + CALL_US
    if plan.splits > 1:
        t += (plan.splits + 1) * m * r * 4 / PASS_BYTES_PER_US
    return t


def best_plan(bodies, m: int, r: int, stages: int, sms: int) -> Plan:
    """The plan of least modelled time among ``bodies`` (first on a tie)."""
    return min((hopper_plan(b, m, r, stages, sms) for b in bodies),
               key=lambda plan: plan_cost(plan, m, r, sms))


def plan_matmul(m: int, r: int, words: int, sms: int, bf16: bool = True,
                body: str | None = None) -> Plan:
    """The plan of one B2 call on a card with ``sms`` SMs: f32 x takes the
    FMA body, bf16 the Hopper body of least modelled time (``body`` forces
    one; the card tests run each)."""
    if not bf16:
        return Plan("fma", TILE_M, TILE_N, words, *split_k(m, r, words, sms))
    stages = -(-words // STAGE_WORDS)
    return best_plan([body] if body else BODIES, m, r, stages, sms)


@functools.lru_cache(maxsize=None)
def _launcher():
    """(library, bound launch function), built and loaded on first use."""
    lib = _build.load("tiled_matmul")
    fn = lib.tbn_tiled_matmul
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def tiled_matmul_unique(x: torch.Tensor, packed: torch.Tensor,
                        plan_shape=None) -> torch.Tensor:
    """u = x @ T^T for a row-packed tile: x (m, words*32) bf16/f32, packed
    (r, words) int32 -> (m, r) float32. Launches kernel B2 for CUDA tensors
    as :func:`plan_matmul` plans it for (m, r), or for ``plan_shape`` (M, R,
    row0, col0): a rank's (m, r) block at (row0, col0) of an (M, R) call,
    summed in the order one card would sum the whole. CPU tensors take the
    plain version, which places the block at its offset for the same
    reason (``plain_product``)."""
    check_operands(x, packed, "tiled_matmul_unique")
    return _matmul_op(x, packed, None if plan_shape is None else list(plan_shape))


def tiled_matmul_body(x: torch.Tensor, packed: torch.Tensor,
                      body: str) -> torch.Tensor:
    """Kernel B2 on bf16 CUDA tensors with the Hopper ``body`` forced in
    place of the planner's pick: the card checks hold every body against
    the plain version and time it beside the cost model."""
    check_operands(x, packed, "tiled_matmul_body")
    if body not in BODIES or x.dtype != torch.bfloat16:
        raise ValueError(f"tiled_matmul_body: body {body!r} on {x.dtype} x; "
                         f"expected bfloat16 and one of {sorted(BODIES)}")
    return _launch(x, packed, body)


def _launch(x: torch.Tensor, packed: torch.Tensor, body,
            plan_shape=None) -> torch.Tensor:
    out, stream = cuda_args(x, packed, "tiled_matmul_unique")
    m, (r, words) = x.shape[0], packed.shape
    bf16 = x.dtype == torch.bfloat16
    pm, pr = plan_shape[:2] if plan_shape else (m, r)
    plan = plan_matmul(pm, pr, words, _sm_count(out.device.index), bf16, body)
    work = (torch.empty((plan.splits, m, r), dtype=torch.float32,
                        device=x.device) if plan.splits > 1 else None)
    lib, launch = _launcher()
    err = launch(x.data_ptr(), packed.data_ptr(), out.data_ptr(),
                 None if work is None else work.data_ptr(), m, r, words,
                 plan.code, plan.splits, plan.per_split, int(bf16), stream)
    _build.check(lib, err, "tiled_matmul_unique")
    tiled_matmul_unique.launches += 1
    return out


def u_shape(x: torch.Tensor, packed: torch.Tensor, dtype=torch.float32):
    """The (m, r) output of B1-B4 for x (m, ...) and packed (r, words)."""
    return x.new_empty((x.shape[0], packed.shape[0]), dtype=dtype)


_matmul_op = kernel_op(
    "tiled_matmul_unique", "(Tensor x, Tensor packed, int[]? plan_shape) -> Tensor",
    lambda x, packed, plan_shape: _launch(x, packed, None, plan_shape),
    lambda x, packed, plan_shape: tiled_matmul_plain(x, packed, plan_shape),
    lambda x, packed, plan_shape: u_shape(x, packed))
tiled_matmul_unique.launches = 0
