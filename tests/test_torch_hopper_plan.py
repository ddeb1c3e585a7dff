"""The host-side planners of kernels B2 and B6 (``plan_matmul``,
``plan_conv``): which body runs, its tile, and the K split, checked at
every main-path shape and the edge cases on a card with 132 SMs. Runs
without a card: the plans are plain integer arithmetic."""
import pytest
import torch

from repro_torch.kernels.tiled_conv import CONV_BODIES, plan_conv, tiled_conv_body
from repro_torch.kernels.tiled_matmul import (
    BODIES,
    MIN_SPLIT_STAGES,
    SMEM_BYTES,
    STAGE_WORDS,
    hopper_plan,
    plan_cost,
    plan_matmul,
    ring_smem,
    tiled_matmul_body,
)

SMS = 132
# (m, K, r) of every B2 call on the main paths: granite-8b's five tiled
# shapes at the extend tick (m = 128), the fused train step (m = 2048) and
# the other phase-2 rows (33, 512), the ResNet-34 head (m = 64, K = 512,
# r = 500), and the edge cases of the card tests (ragged m and r, odd word
# counts, one word)
GRANITE = ((4096, 512), (4096, 128), (4096, 1792), (14336, 512), (4096, 6144))
# the (K, r) of qwen1.5-32b, starcoder2-7b and minitron-8b that granite-8b
# has not (tests/test_torch_matvec_plan.py); r = 3424 ends B2's tiles ragged
DENSE_FAMILY = ((5120, 640), (5120, 3424), (27392, 640), (5120, 19008),
                (4608, 576), (4608, 64), (4608, 2304), (18432, 576),
                (4608, 6144), (4096, 2048), (16384, 512), (4096, 32000))
# the (K, r) of mamba2-370m (p = 4: in_proj, out_proj, lm_head) and of
# recurrentgemma-2b (p = 8: q/o and the RG-LRU projections, k/v, gate/up,
# down, lm_head); r = 1096 and 12570 are not multiples of 16
SSM_HYBRID = ((1024, 1096), (2048, 256), (1024, 12570), (2560, 320),
              (2560, 32), (2560, 960), (7680, 320), (2560, 32000))
MATMUL_CASES = ([(m, k, r) for m in (33, 128, 512, 2048) for k, r in GRANITE]
                + [(m, k, r) for m in (33, 128, 512) for k, r in DENSE_FAMILY]
                + [(m, k, r) for m in (33, 128, 512) for k, r in SSM_HYBRID]
                + [(64, 512, 500), (130, 96, 130), (65, 160, 65),
                   (200, 160, 64), (33, 96, 24), (2048, 96, 100), (40, 32, 1),
                   (128, 200 * 32, 24)])
# (N, input H = W, C, r, kernel, stride) of B6: ResNet-34's four tiled
# shapes at N in {1, 64} (SAME padding), and the card tests' edge cases
RESNET = ((28, 128, 128, 3, 2), (14, 256, 128, 3, 1), (14, 256, 256, 3, 2),
          (7, 512, 256, 3, 1))
CONV_CASES = ([(n,) + s for n in (1, 64) for s in RESNET]
              + [(3, 11, 64, 100, 3, 2), (2, 8, 64, 512, 1, 2),
                 (1, 7, 32, 1, 1, 1), (2, 9, 32, 40, 3, 1), (2, 9, 96, 40, 3, 1),
                 (64, 14, 32, 2048, 3, 1)])


def _conv_m(n, h, k, s):
    return n * (-(-h // s)) ** 2 if k == 3 else n * ((h - k) // s + 1) ** 2


def _check_split(plan):
    """Every K split is non-empty and the splits cover [0, units) exactly
    once, in order; a Hopper split starts at an even stage (stages come in
    pairs that share a word tile)."""
    if plan.body != "fma" and plan.splits > 1:
        assert plan.per_split % 2 == 0
    covered = []
    for z in range(plan.splits):
        lo = z * plan.per_split
        hi = min(plan.units, lo + plan.per_split)
        assert hi > lo, f"split {z} of {plan} is empty"
        covered.extend(range(lo, hi))
    assert covered == list(range(plan.units))


def _check_launch(plan, m, r):
    x, y, z = plan.grid(m, r)
    assert 1 <= x <= 2**31 - 1 and 1 <= y <= 65535 and 1 <= z <= 65535
    if plan.body == "fma":
        return
    assert ring_smem(plan.body) + 64 <= SMEM_BYTES   # + the mbarriers


@pytest.mark.parametrize("m,k,r", MATMUL_CASES)
def test_matmul_plan_covers_k_and_fits_the_card(m, k, r):
    words = k // 32
    plan = plan_matmul(m, r, words, SMS)
    _check_split(plan)
    _check_launch(plan, m, r)
    assert plan.units == -(-words // STAGE_WORDS)
    tiles = -(-m // plan.bn) * -(-r // plan.bm)
    # split only where the grid is short of the SMs, and at most one wave
    assert plan.splits == 1 or tiles * plan.splits <= SMS
    assert plan.splits == 1 or tiles < SMS


@pytest.mark.parametrize("m,k,r", MATMUL_CASES)
def test_matmul_plan_body_rule(m, k, r):
    """bf16 takes the Hopper body of least modelled time, with its tile
    and split; f32 the FMA body over words."""
    stages = -(-(k // 32) // STAGE_WORDS)
    plan = plan_matmul(m, r, k // 32, SMS)
    costs = {b: plan_cost(hopper_plan(b, m, r, stages, SMS), m, r, SMS)
             for b in BODIES}
    assert plan_cost(plan, m, r, SMS) == min(costs.values())
    assert plan == hopper_plan(plan.body, m, r, stages, SMS)
    assert (plan.code, plan.bm, plan.bn) == BODIES[plan.body]
    f32 = plan_matmul(m, r, k // 32, SMS, bf16=False)
    assert f32.body == "fma" and f32.code == 0 and f32.units == k // 32
    _check_split(f32)


# The planner's picks at the main-path shapes, as PERF.md gives them
# (K, r) -> body at the extend tick (m = 128) and the train step (m = 2048)
MAIN_PICKS = {(4096, 512): ("wg128x64", "wg128x256"),
              (4096, 128): ("wg128x64", "wg128x128"),
              (4096, 1792): ("wg128x128", "wg128x256"),
              (14336, 512): ("wg128x64", "wg128x256"),
              (4096, 6144): ("wg256x128", "wg128x256")}


@pytest.mark.parametrize("k,r", sorted(MAIN_PICKS))
def test_matmul_plan_at_the_main_shapes(k, r):
    for m, body in zip((128, 2048), MAIN_PICKS[(k, r)]):
        assert plan_matmul(m, r, k // 32, SMS).body == body


@pytest.mark.parametrize("body", sorted(BODIES))
@pytest.mark.parametrize("m,k,r", [(33, 96, 24), (2048, 4096, 1792),
                                   (128, 14336, 512)])
def test_matmul_forced_body(body, m, k, r):
    plan = plan_matmul(m, r, k // 32, SMS, body=body)
    assert plan.body == body and plan.code == BODIES[body][0]
    _check_split(plan)
    _check_launch(plan, m, r)


@pytest.mark.parametrize("n,h,c,r,k,s", CONV_CASES)
def test_conv_plan_covers_k_and_fits_the_card(n, h, c, r, k, s):
    m, words = _conv_m(n, h, k, s), c // 32
    plan = plan_conv(m, r, (k, k), words, SMS)
    _check_split(plan)
    _check_launch(plan, m, r)
    # a stage is one kernel position's pair of words
    assert plan.units == k * k * -(-words // STAGE_WORDS)
    tiles = -(-m // plan.bn) * -(-r // plan.bm)
    assert plan.splits == 1 or tiles * plan.splits <= SMS


@pytest.mark.parametrize("n,h,c,r,k,s", CONV_CASES)
def test_conv_plan_body_rule(n, h, c, r, k, s):
    """B6 takes the body of CONV_BODIES of least modelled time over its
    pixels; f32 the FMA body over (i, j, word) steps."""
    m = _conv_m(n, h, k, s)
    stages = k * k * -(-(c // 32) // STAGE_WORDS)
    plan = plan_conv(m, r, (k, k), c // 32, SMS)
    assert plan.body in CONV_BODIES
    assert plan_cost(plan, m, r, SMS) == min(
        plan_cost(hopper_plan(b, m, r, stages, SMS), m, r, SMS)
        for b in CONV_BODIES)
    f32 = plan_conv(m, r, (k, k), c // 32, SMS, bf16=False)
    assert f32.body == "fma" and f32.units == k * k * (c // 32)
    _check_split(f32)


def test_conv_plan_at_resnet34_n1_and_n64():
    """As PERF.md states: at N = 1 (196 and 49 pixels) 64-pixel tiles with
    K split; at N = 64 128 x 128 tiles, unsplit at the 14x14 shapes (98
    tiles), split in two at the 7x7 entry, and 256 x 128 tiles split in
    five at the 7x7x512 shape."""
    want = {1: [("wg128x64", 3), ("wg128x64", 9), ("wg128x64", 9),
                ("wg128x64", 18)],
            64: [("wg128x128", 1), ("wg128x128", 1), ("wg128x128", 2),
                 ("wg256x128", 5)]}
    for n in (1, 64):
        got = []
        for _, h, c, r, k, s in [case for case in CONV_CASES[:8] if case[0] == n]:
            plan = plan_conv(_conv_m(n, h, k, s), r, (k, k), c // 32, SMS)
            got.append((plan.body, plan.splits))
        assert got == want[n]


def test_ring_fits_shared_memory():
    for body in BODIES:
        assert ring_smem(body) % 1024 == 0
        assert ring_smem(body) <= SMEM_BYTES - 64


@pytest.mark.parametrize("body,dtype", [("wg64", torch.bfloat16),
                                        ("wg128x128", torch.float32)])
def test_forced_bodies_refuse_an_unknown_body_or_f32(body, dtype):
    """The card checks' entry points take only a known bf16 body, and
    launch no plain version: a CPU tensor has no kernel."""
    x = torch.zeros((4, 32), dtype=dtype)
    packed = torch.zeros((3, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="expected bfloat16"):
        tiled_matmul_body(x, packed, body)
    with pytest.raises(ValueError, match="expected bfloat16"):
        tiled_conv_body(torch.zeros((1, 3, 3, 32), dtype=dtype),
                        torch.zeros((9, 2, 1), dtype=torch.int32), body,
                        kernel=(3, 3), stride=(1, 1), out_hw=(1, 1))


def test_forced_bodies_have_no_cpu_path():
    x = torch.zeros((4, 32), dtype=torch.bfloat16)
    packed = torch.zeros((3, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        tiled_matmul_body(x, packed, "wg128x64")
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        tiled_conv_body(torch.zeros((1, 3, 3, 32), dtype=torch.bfloat16),
                        torch.zeros((9, 2, 1), dtype=torch.int32), "wg128x64",
                        kernel=(3, 3), stride=(1, 1), out_hw=(1, 1))


def test_lib_path_hashes_the_shared_headers(tmp_path, monkeypatch):
    """An edited csrc/*.cuh (the Hopper mainloop B2 and B6 include) must
    rebuild both libraries: lib_path hashes every header with the source."""
    from repro_torch.kernels import _build

    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.lib_path("k")
    assert before == _build.lib_path("k")
    (tmp_path / "h.cuh").write_text("// v2\n")
    assert _build.lib_path("k") != before
