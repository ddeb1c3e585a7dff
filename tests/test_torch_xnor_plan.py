"""Kernel B3's host side: the planner ``plan_xnor`` (body, K whole or split
in whole 8-word steps and added in a cluster) at every decode-sized m and every
full-width granite-8b shape on a card with 132 SMs, the forced-body entry's
refusals, and a pure-torch emulation of the tensor-core body's integer
arithmetic (AND-popcount, the popcounts of x and of the tile, n_in added
once), split by split and warp by warp as ``csrc/decode_mma.cuh`` cuts the
work, held exactly to the plain version and to the JAX reference. Runs
without a card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.packing import pack_bits as j_pack_bits
from repro.kernels import tiled_xnor as j_x
from repro.kernels.tiled_matvec import sublane_rounded
from repro_torch.kernels.tiled_matmul import SMEM_BYTES
from repro_torch.kernels.tiled_matvec import (
    MATVEC_MAX_M,
    MAX_SMEM,
    matvec_cost,
    max_split_words,
    stage_bytes,
)
from repro_torch.kernels.tiled_xnor import (
    B3_COST,
    XNOR_BODIES,
    XNOR_CLUSTER,
    XNOR_POPC_MAX_M,
    XNOR_REDUCE,
    XNOR_STEP,
    plan_xnor,
    popcount32,
    quantize_sign,
    tiled_xnor_body,
    xnor_matvec_words,
    xnor_plans,
)

torch.set_num_threads(2)
SMS = 132
# (K, r) of every tiled matmul of a full-width granite-8b layer: q/o, k/v,
# gate/up, down, and the LM head
GRANITE = ((4096, 512), (4096, 128), (4096, 1792), (14336, 512), (4096, 6144))
# the (K, r) of qwen1.5-32b, starcoder2-7b and minitron-8b that granite-8b
# has not (tests/test_torch_matvec_plan.py)
DENSE_FAMILY = ((5120, 640), (5120, 3424), (27392, 640), (5120, 19008),
                (4608, 576), (4608, 64), (4608, 2304), (18432, 576),
                (4608, 6144), (4096, 2048), (16384, 512), (4096, 32000))
# the (K, r) of mamba2-370m (p = 4: in_proj, out_proj, lm_head) and of
# recurrentgemma-2b (p = 8: q/o and the RG-LRU projections, k/v, gate/up,
# down, lm_head); r = 1096 and 12570 are not multiples of 16
SSM_HYBRID = ((1024, 1096), (2048, 256), (1024, 12570), (2560, 320),
              (2560, 32), (2560, 960), (7680, 320), (2560, 32000))
# odd word counts, one word, words not a multiple of 8, r past every tile
RAGGED = ((32, 1), (96, 130), (160, 65), (320, 24), (2080, 65), (14336, 48))
MS = range(1, MATVEC_MAX_M + 1)
VARIANTS = [("popc", None)] + [(b, red) for b in XNOR_BODIES if b != "popc"
                               for red in XNOR_REDUCE]


def _check_plan(plan, m, r, words):
    """The splits cover [0, words) once, in order, none empty; a split K is
    cut in whole steps; what a block stages fits its shared memory; a
    cluster has at most XNOR_CLUSTER blocks."""
    covered = []
    for z in range(plan.splits):
        lo, hi = z * plan.per_split, min(words, (z + 1) * plan.per_split)
        assert hi > lo, f"split {z} of {plan} is empty"
        covered.extend(range(lo, hi))
    assert covered == list(range(words))
    x, y = plan.grid(r)
    assert 1 <= x <= 2**31 - 1 and 1 <= y <= 65535
    if plan.code == 0:
        assert (plan.bf, plan.splits, plan.per_split, plan.cluster) == (2, 1, words, False)
        return
    if plan.splits > 1:
        assert plan.per_split % XNOR_STEP == 0
    assert stage_bytes(m, plan.bf, plan.per_split, 4, XNOR_STEP,
                       plan.cluster) <= MAX_SMEM <= SMEM_BYTES
    assert not plan.cluster or 1 < plan.splits <= XNOR_CLUSTER


@pytest.mark.parametrize("k,r", GRANITE + DENSE_FAMILY + SSM_HYBRID)
@pytest.mark.parametrize("m", MS)
def test_plan_covers_k_fits_and_is_the_least_modelled_time(m, k, r):
    words = k // 32
    plan = plan_xnor(m, r, words, SMS)
    assert plan.body in XNOR_BODIES and plan.code == XNOR_BODIES[plan.body][0]
    _check_plan(plan, m, r, words)
    offered = [p for b in XNOR_BODIES if b != "popc" or m <= XNOR_POPC_MAX_M
               for p in xnor_plans(m, r, words, SMS, b)]
    costs = [matvec_cost(p, B3_COST, m, r, words, SMS) for p in offered]
    assert plan == offered[costs.index(min(costs))]
    assert all(plan_xnor.__wrapped__(m, r, words, SMS) == plan for _ in range(3))


@pytest.mark.parametrize("m", (1, 8, 9, 32))
def test_plan_falls_back_to_popc_past_every_tensor_core_plan(m):
    """A K too long for XNOR_CLUSTER splits in shared memory has no
    tensor-core plan: the planner takes "popc", which has no limit on K,
    and a forced tensor-core body is refused."""
    words = XNOR_CLUSTER * max_split_words(m, 16, 4, XNOR_STEP, True) + XNOR_STEP
    assert all(xnor_plans(m, 512, words, SMS, b) == [] for b in XNOR_BODIES if b != "popc")
    plan = plan_xnor(m, 512, words, SMS)
    assert plan.body == "popc"
    _check_plan(plan, m, 512, words)
    with pytest.raises(ValueError, match="has no"):
        plan_xnor(m, 512, words, SMS, "bmma16")


@pytest.mark.parametrize("body,reduce", VARIANTS)
@pytest.mark.parametrize("k,r", GRANITE + RAGGED)
@pytest.mark.parametrize("m", (1, 4, 8, 9, 17, 32))
def test_every_forced_variant_covers_k_and_fits(body, reduce, m, k, r):
    """A forced body and reduction is that plan, or refused where it does
    not exist (K of one step cannot split; one block cannot hold K)."""
    words = -(-k // 32)
    have = {p.reduce: p for p in xnor_plans(m, r, words, SMS, body)}
    if body != "popc" and reduce not in have:
        with pytest.raises(ValueError, match="has no"):
            plan_xnor(m, r, words, SMS, body, reduce)
        return
    plan = plan_xnor(m, r, words, SMS, body, reduce)
    assert (plan.code, plan.bf) == XNOR_BODIES[body]
    assert body == "popc" or plan.reduce == reduce
    _check_plan(plan, m, r, words)


# The planner's picks (body/reduction/splits) at the main-path shapes (q/o,
# k/v, gate/up, down, lm_head), as PERF.md gives them
MAIN_PICKS = {4: ("popc", "popc", "bmma16/none/1", "popc", "bmma64/none/1"),
              32: ("bmma16/none/1", "bmma16/none/1", "bmma16/none/1",
                   "bmma32/cluster/8", "bmma64/none/1")}


@pytest.mark.parametrize("m", sorted(MAIN_PICKS))
def test_plan_at_the_main_shapes(m):
    got = tuple(p.body if p.code == 0 else f"{p.body}/{p.reduce}/{p.splits}"
                for p in (plan_xnor(m, r, k // 32, SMS) for k, r in GRANITE))
    assert got == MAIN_PICKS[m]


@pytest.mark.parametrize("m", (XNOR_POPC_MAX_M + 1, 16, 32))
def test_popc_is_not_offered_past_its_row_limit(m):
    for k, r in GRANITE:
        assert plan_xnor(m, r, k // 32, SMS).code != 0
        assert plan_xnor(m, r, k // 32, SMS, "popc").code == 0   # forced


@pytest.mark.parametrize("body,reduce", [("mma16", None), ("bmma256", None),
                                         ("bmma16", "atomic"), ("bmma16", "pass"),
                                         ("popc", "tree")])
def test_forced_body_refuses_unknown_names(body, reduce):
    x = torch.zeros((4, 1), dtype=torch.int32)
    rows = torch.zeros((3, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="expected one of"):
        tiled_xnor_body(x, rows, body, n_in=32, reduce=reduce)


@pytest.mark.parametrize("body,reduce", VARIANTS)
def test_forced_bodies_have_no_cpu_path(body, reduce):
    """The forced entry launches no plain version: a CPU tensor has no
    kernel."""
    x = torch.zeros((4, 128), dtype=torch.int32)
    rows = torch.zeros((3, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        tiled_xnor_body(x, rows, body, n_in=4096, reduce=reduce)


def test_forced_body_refuses_m_over_the_limit():
    x = torch.zeros((MATVEC_MAX_M + 1, 4), dtype=torch.int32)
    rows = torch.zeros((3, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="exceeds"):
        tiled_xnor_body(x, rows, "bmma16", n_in=128)


# --------------------------------------------------------------------------
# The tensor-core body's arithmetic, emulated
# --------------------------------------------------------------------------
def emulate_bmma(packed_x, packed_rows, n_in, plan):
    """What the tensor-core body computes, in its order of cuts: split z
    stages words [z * per, z * per + n) zero-filled to whole steps; warp kp
    of a 16-filter group takes steps [lo, hi) of them and turns its AND
    popcount C into 4 C - 2 (px + pt) over its words; split 0 adds n_in;
    the splits' tiles are added (any order gives the same integers)."""
    m, words = packed_x.shape
    r = packed_rows.shape[0]
    fw = plan.bf // 16
    warps = max(4, fw) // fw
    out = torch.zeros((m, r), dtype=torch.int64)
    for z in range(plan.splits):
        w0 = z * plan.per_split
        n = min(words, w0 + plan.per_split) - w0
        ns = -(-n // XNOR_STEP) * XNOR_STEP
        xs = torch.zeros((m, ns), dtype=torch.int32)
        ts = torch.zeros((r, ns), dtype=torch.int32)
        xs[:, :n] = packed_x[:, w0:w0 + n]
        ts[:, :n] = packed_rows[:, w0:w0 + n]
        steps = ns // XNOR_STEP
        part = -(-steps // warps)
        tile = torch.zeros((m, r), dtype=torch.int64)
        for kp in range(warps):
            lo = min(steps, kp * part) * XNOR_STEP
            hi = min(steps * XNOR_STEP, lo + part * XNOR_STEP)
            xw, tw = xs[:, lo:hi], ts[:, lo:hi]
            c = popcount32(xw[:, None, :] & tw[None, :, :]).sum(-1).long()
            px = popcount32(xw).sum(-1).long()
            pt = popcount32(tw).sum(-1).long()
            tile += 4 * c - 2 * (px[:, None] + pt[None, :])
        out += tile + (n_in if z == 0 else 0)
    return out.to(torch.int32)


# pad bits (n_in % 32), one partial step, words not a multiple of 8 or 4,
# ragged r, and a granite-width K
EMU_CASES = [(1, 32, 1), (4, 80, 24), (3, 96, 130), (17, 160, 65), (9, 300, 24),
             (32, 1000, 130), (5, 2080, 65), (24, 4096, 40), (2, 14336, 17)]


def _operands(m, n_in, r, seed):
    """Sign-packed activations and a pack_bits tile (pad bits 0 on both)
    from numpy, packed by the JAX package as the reference does."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, n_in)).astype(np.float32)
    t = np.where(rng.random((r, n_in)) < 0.5, 1.0, -1.0).astype(np.float32)
    rows = torch.from_numpy(np.array(j_pack_bits(jnp.asarray(t))))
    return quantize_sign(torch.from_numpy(x), n_in)[0], rows


@pytest.mark.parametrize("body,reduce", VARIANTS[1:])
@pytest.mark.parametrize("m,n_in,r", EMU_CASES)
def test_tensor_core_arithmetic_equals_the_plain_version(m, n_in, r, body, reduce):
    px, rows = _operands(m, n_in, r, m * n_in + r)
    words = rows.shape[1]
    plans = {p.reduce: p for p in xnor_plans(m, r, words, SMS, body)}
    # a reduction the shape has not (one step: no split) takes the first plan
    plan = plans.get(reduce) or next(iter(plans.values()))
    got = emulate_bmma(px, rows, n_in, plan)
    assert torch.equal(got, xnor_matvec_words(px, rows, n_in=n_in))


def _pad(a, axis, mult):
    pad = (-a.shape[axis]) % mult
    if not pad:
        return a
    w = [(0, 0)] * a.ndim
    w[axis] = (0, pad)
    return jnp.pad(a, w)


@pytest.mark.parametrize("body,reduce", VARIANTS[1:])
@pytest.mark.parametrize("m", (1, 8, 32))
def test_tensor_core_arithmetic_at_qwen_down(m, body, reduce):
    """qwen1.5-32b's down projection, K = 27,392 (856 words, 107 steps):
    every tensor-core plan's emulation equals the plain version. K splits 8
    times in a cluster for every body but the widest at m = 32, whose
    stage of x and 128 filters leaves too little room; K whole fits only
    the narrowest body at few rows. A variant the shape has not is
    refused."""
    n_in, r = 27392, 24
    words = n_in // 32
    plans = {p.reduce: p for p in xnor_plans(m, r, words, SMS, body)}
    assert ("cluster" in plans) == (body != "bmma128" or m < 32)
    if reduce not in plans:
        with pytest.raises(ValueError, match="has no"):
            plan_xnor(m, r, words, SMS, body, reduce)
        return
    px, rows = _operands(m, n_in, r, m + 1)
    got = emulate_bmma(px, rows, n_in, plans[reduce])
    assert torch.equal(got, xnor_matvec_words(px, rows, n_in=n_in))


@pytest.mark.parametrize("m,n_in,r", EMU_CASES[:7])
def test_tensor_core_arithmetic_equals_the_jax_reference(m, n_in, r):
    """Every tensor-core plan's emulation against the Pallas kernel in
    interpret mode, padded as ``repro.kernels.ops`` pads it."""
    px, rows = _operands(m, n_in, r, 7 * m + n_in + r)
    words = rows.shape[1]
    bw, br = min(32, words), min(256, r)
    xq = _pad(_pad(jnp.asarray(px.numpy()), 0, sublane_rounded(m, jnp.int32)), 1, bw)
    tm = _pad(_pad(jnp.asarray(rows.numpy()), 0, br), 1, bw)
    want = np.asarray(j_x.tiled_xnor_matvec_unique(
        xq, tm, n_in=n_in, block_r=br, block_w=bw, interpret=True))[:m, :r]
    for body in XNOR_BODIES:
        for plan in xnor_plans(m, r, words, SMS, body):
            if plan.code:
                np.testing.assert_array_equal(emulate_bmma(px, rows, n_in, plan).numpy(),
                                              want)


def test_cost_fit_reads_the_b3_survey(tmp_path, capsys):
    """The fitting script parses phase 2's B3 lines (names with the split
    reduction) and reports the fit and the planner's picks."""
    from repro_torch.kernels import fit_matvec_cost

    lines = []
    for m in (1, 8, 32):
        for name, (k, r) in zip(("q/o", "k/v", "gate/up"), GRANITE):
            plans = [p for b in XNOR_BODIES for p in xnor_plans(m, r, k // 32, SMS, b)]
            survey = ", ".join(
                f"{p.body if p.code == 0 else p.body + '/' + p.reduce} "
                f"{0.002 + 1e-4 * m * (i + 1):.4f}ms (model 0.0030, {p.splits} splits)"
                for i, p in enumerate(plans))
            lines.append(f"B3 {name:8s} K={k:5d} r={r:4d} m={m:3d} xnor     "
                         f"exact (max|acc|=100) kernel 0.0030ms [x] bodies: {survey}")
    log = tmp_path / "smoke.log"
    log.write_text("\n".join(lines) + "\n")
    rows = fit_matvec_cost.survey(str(log))["B3"]
    assert len(rows) == sum(len(l.split("ms (model")) - 1 for l in lines)
    assert rows[0][:6] == ("q/o", 1, 512, 128, "popc", 1)
    assert {r[4] for r in rows} >= {"bmma16/none", "bmma16/cluster"}
    fit_matvec_cost.main(str(log))
    out = capsys.readouterr().out
    assert "B3 mma: fitted" in out and "B3 installed planner" in out
