"""The host-side planners of kernels B1 and B4 (``plan_matvec``,
``plan_int8``): which body runs, its filters per block, and the K split,
checked at every decode-sized m and every full-width granite-8b shape on a
card with 132 SMs. Runs without a card: the plans are plain integer
arithmetic."""
import pytest
import torch

from repro_torch.kernels.tiled_matmul import SMEM_BYTES
from repro_torch.kernels.tiled_matvec import (
    B1_COST,
    MATVEC_MAX_M,
    MAX_SMEM,
    MV_BODIES,
    matvec_cost,
    matvec_plan,
    max_split_words,
    plan_matvec,
    stage_bytes,
    tiled_matvec_body,
)
from repro_torch.kernels.tiled_xnor import (
    B4_COST,
    INT8_BODIES,
    plan_int8,
    tiled_int8_body,
)

SMS = 132
# (K, r) of every tiled matmul of a full-width granite-8b layer: q/o, k/v,
# gate/up, down, and the LM head
GRANITE = ((4096, 512), (4096, 128), (4096, 1792), (14336, 512), (4096, 6144))
# the (K, r) of qwen1.5-32b, starcoder2-7b and minitron-8b that granite-8b
# has not: q/k/v/o, gate/up, down and lm_head, r = n_out / 8
DENSE_FAMILY = ((5120, 640), (5120, 3424), (27392, 640), (5120, 19008),
                (4608, 576), (4608, 64), (4608, 2304), (18432, 576),
                (4608, 6144), (4096, 2048), (16384, 512), (4096, 32000))
# the (K, r) of mamba2-370m (p = 4: in_proj, out_proj, lm_head) and of
# recurrentgemma-2b (p = 8: q/o and the RG-LRU projections, k/v, gate/up,
# down, lm_head); r = 1096 and 12570 are not multiples of 16
SSM_HYBRID = ((1024, 1096), (2048, 256), (1024, 12570), (2560, 320),
              (2560, 32), (2560, 960), (7680, 320), (2560, 32000))
# the card tests' ragged shapes: odd word counts, one word, r not a
# multiple of any filter tile
RAGGED = ((32, 1), (96, 130), (160, 65), (1568, 100), (544, 24), (14336, 48))
MS = range(1, MATVEC_MAX_M + 1)
# kernel -> (planner, bodies, cost model, bytes of an x element)
KERNELS = {"B1": (lambda m, r, w, body=None: plan_matvec(m, r, w, SMS, body=body),
                  MV_BODIES, B1_COST, 2),
           "B4": (lambda m, r, w, body=None: plan_int8(m, r, w, SMS, body=body),
                  INT8_BODIES, B4_COST, 1)}


def _check_split(plan, words):
    """Every K split is non-empty and the splits cover [0, words) exactly
    once, in order."""
    covered = []
    for z in range(plan.splits):
        lo = z * plan.per_split
        hi = min(words, lo + plan.per_split)
        assert hi > lo, f"split {z} of {plan} is empty"
        covered.extend(range(lo, hi))
    assert covered == list(range(words))


def _check_plan(plan, m, r, words, x_bytes):
    _check_split(plan, words)
    x, y = plan.grid(r)
    assert 1 <= x <= 2**31 - 1 and 1 <= y <= 65535
    if plan.code == 0:
        # the CUDA-core bodies: two filters a block, no K split
        assert (plan.bf, plan.splits, plan.per_split) == (2, 1, words)
        return
    # a tensor-core plan fills the card wherever the words allow, every
    # split staged whole in shared memory
    cap = max_split_words(m, plan.bf, 32 * x_bytes)
    assert plan.blocks(r) >= SMS or plan.splits == words
    assert plan.per_split <= cap
    assert stage_bytes(m, plan.bf, plan.per_split, 32 * x_bytes) <= MAX_SMEM <= SMEM_BYTES
    # with the fewest splits that do: aiming at one split fewer would leave
    # SMs idle or a split too long for shared memory
    if plan.splits > 1:
        per = -(-words // (plan.splits - 1))
        assert x * -(-words // per) < SMS or per > cap


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("k,r", GRANITE + DENSE_FAMILY + SSM_HYBRID)
@pytest.mark.parametrize("m", MS)
def test_plan_covers_k_fills_the_card_and_fits(kernel, m, k, r):
    plan_of, bodies, cost, x_bytes = KERNELS[kernel]
    plan = plan_of(m, r, k // 32)
    assert plan.body in bodies and plan.code == bodies[plan.body][0]
    _check_plan(plan, m, r, k // 32, x_bytes)
    # the same inputs always pick the same plan
    assert all(plan_of(m, r, k // 32) == plan for _ in range(3))


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("k,r", GRANITE + RAGGED)
@pytest.mark.parametrize("m", (1, 3, 4, 8, 9, 16, 17, 24, 32))
def test_every_forced_body_covers_k_and_fits(kernel, m, k, r):
    plan_of, bodies, _, x_bytes = KERNELS[kernel]
    for body in bodies:
        plan = plan_of(m, r, k // 32, body)
        assert plan.body == body and (plan.code, plan.bf) == bodies[body]
        _check_plan(plan, m, r, k // 32, x_bytes)


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("k,r", GRANITE + DENSE_FAMILY + SSM_HYBRID)
@pytest.mark.parametrize("m", (1, 2, 4, 8, 16, 32))
def test_plan_is_the_least_modelled_time(kernel, m, k, r):
    """The planner picks the body of least modelled time (the first such
    body in table order on a tie), with that body's split."""
    plan_of, bodies, cost, x_bytes = KERNELS[kernel]
    words = k // 32
    plans = [matvec_plan(bodies, b, m, r, words, SMS, 32 * x_bytes) for b in bodies]
    costs = [matvec_cost(p, cost, m, r, words, SMS) for p in plans]
    plan = plan_of(m, r, words)
    assert plan == plans[costs.index(min(costs))]


# The planner's picks at the main-path shapes (q/o, k/v, gate/up, down,
# lm_head), as PERF.md gives them: the 4-slot decode tick and the widest one
MAIN_PICKS = {("B1", 4): ("simt", "simt", "mma128", "mma128", "mma64"),
              ("B1", 32): ("mma64", "mma32", "mma128", "mma128", "mma128"),
              ("B4", 4): ("dp4a", "dp4a", "dp4a", "dp4a", "mma64"),
              ("B4", 32): ("mma32", "mma16", "mma64", "mma64", "mma64")}


@pytest.mark.parametrize("kernel,m", sorted(MAIN_PICKS))
def test_plan_at_the_main_shapes(kernel, m):
    plan_of = KERNELS[kernel][0]
    got = tuple(plan_of(m, r, k // 32).body for k, r in GRANITE)
    assert got == MAIN_PICKS[(kernel, m)]


def test_f32_x_takes_the_cuda_core_body():
    for m in (1, 4, 32):
        for k, r in GRANITE:
            plan = plan_matvec(m, r, k // 32, SMS, bf16=False)
            assert plan.body == "simt" and plan.splits == 1


def test_tensor_core_bodies_at_m32():
    """At m = MATVEC_MAX_M every granite-8b shape takes a tensor-core body
    of both kernels (the CUDA-core bodies' cost grows with m)."""
    for k, r in GRANITE:
        assert plan_matvec(32, r, k // 32, SMS).code != 0
        assert plan_int8(32, r, k // 32, SMS).code != 0


@pytest.mark.parametrize("body,dtype", [("mma256", torch.bfloat16),
                                        ("mma16", torch.float32),
                                        ("wg128x64", torch.bfloat16)])
def test_forced_matvec_body_refuses_an_unknown_body_or_f32(body, dtype):
    x = torch.zeros((4, 32), dtype=dtype)
    packed = torch.zeros((3, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="expected one of"):
        tiled_matvec_body(x, packed, body)


def test_forced_int8_body_refuses_an_unknown_body():
    q = torch.zeros((4, 32), dtype=torch.int8)
    packed = torch.zeros((3, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="expected one of"):
        tiled_int8_body(q, packed, "simt")


@pytest.mark.parametrize("body", sorted(MV_BODIES))
def test_forced_bodies_have_no_cpu_path(body):
    """The forced entry points launch no plain version: a CPU tensor has no
    kernel."""
    x = torch.zeros((4, 32), dtype=torch.bfloat16)
    packed = torch.zeros((3, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        tiled_matvec_body(x, packed, body)
    int8_body = body if body in INT8_BODIES else "dp4a"
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        tiled_int8_body(torch.zeros((4, 32), dtype=torch.int8), packed, int8_body)


def test_forced_bodies_refuse_m_over_the_limit():
    x = torch.zeros((MATVEC_MAX_M + 1, 32), dtype=torch.bfloat16)
    packed = torch.zeros((3, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="exceeds"):
        tiled_matvec_body(x, packed, "mma16")
    with pytest.raises(ValueError, match="exceeds"):
        tiled_int8_body(torch.zeros((MATVEC_MAX_M + 1, 32), dtype=torch.int8),
                        packed, "mma16")


def test_cost_fit_reads_the_body_survey(tmp_path, capsys):
    """The fitting script parses phase 2's body lines of both kernels and
    reports the fit and the planner's picks."""
    from repro_torch.kernels import fit_matvec_cost

    log = tmp_path / "smoke.log"
    lines = []
    for k, dt, bodies in (("B1", "bfloat16", MV_BODIES), ("B4", "int8", INT8_BODIES)):
        for m in (1, 8, 32):
            for name, (kk, r) in zip(("q/o", "k/v", "gate/up"), GRANITE):
                plan_of = KERNELS[k][0]
                survey = ", ".join(
                    f"{b} {0.002 + 1e-4 * m * (i + 1):.4f}ms (model 0.0030, "
                    f"{plan_of(m, r, kk // 32, b).splits} splits)"
                    for i, b in enumerate(bodies))
                lines.append(f"{k} {name:8s} K={kk:5d} r={r:4d} m={m:3d} {dt:8s} "
                             f"kernel 0.0030ms | [x] bodies: {survey}")
    log.write_text("\n".join(lines) + "\n")
    rows = fit_matvec_cost.survey(str(log))
    assert len(rows["B1"]) == 9 * len(MV_BODIES) and len(rows["B4"]) == 9 * len(INT8_BODIES)
    assert rows["B1"][0][:6] == ("q/o", 1, 512, 128, "simt", 1)
    fit_matvec_cost.main(str(log))
    out = capsys.readouterr().out
    assert "B1 mma: fitted" in out and "B4 installed planner" in out
