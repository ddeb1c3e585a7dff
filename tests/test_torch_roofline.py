"""The port's roofline (``repro_torch.roofline``) against the JAX package's
``repro.roofline`` on the same inputs, and the one formula of the kernels'
work against the bound formulas ``chip_smoke.py`` wrote inline before it
took them from here.

The two packages' hardware constants differ (Hopper against TPU v5e), so
the times are compared with each package's own constants set apart:
t * peak is the same count on both sides. Counts are exact (rtol 1e-12).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.roofline import analysis as j_an
from repro.roofline import hw as j_hw
from repro_torch.configs import SHAPES, get_config
from repro_torch.kernels.tiled_matmul import tiled_matmul_unique
from repro_torch.roofline import analysis as an
from repro_torch.roofline import hw

EXACT = dict(rtol=1e-12, atol=0)
TERMS = [
    dict(flops=3.5e15, bytes_hbm=2.25e12, bytes_coll=4.0e10,
         coll_breakdown={"all-reduce": 3.0e10, "all-gather": 1.0e10}, int_ops=0.0),
    dict(flops=1.0e9, bytes_hbm=7.5e11, bytes_coll=0.0, coll_breakdown={},
         int_ops=6.4e13),
    dict(flops=0.0, bytes_hbm=1.0, bytes_coll=9.0e12,
         coll_breakdown={"reduce-scatter": 9.0e12}, int_ops=1.0),
]


def _pair(kw):
    return an.RooflineTerms(**kw), j_an.RooflineTerms(**kw)


def _counts(t, peaks):
    """The counts behind a terms object's times: t * peak for each term."""
    return np.array([t.t_compute * peaks[0], t.t_int * peaks[1],
                     t.t_memory * peaks[2], t.t_collective * peaks[3]])


PORT_PEAKS = (hw.PEAK_FLOPS_BF16, hw.PEAK_OPS_INT8, hw.HBM_BW, hw.LINK_BW)
REF_PEAKS = (j_hw.PEAK_FLOPS_BF16, j_hw.PEAK_OPS_INT8, j_hw.HBM_BW, j_hw.ICI_BW)


@pytest.mark.parametrize("i", range(len(TERMS)))
def test_roofline_terms_arithmetic_matches_reference(i):
    got, want = _pair(TERMS[i])
    np.testing.assert_allclose(_counts(got, PORT_PEAKS), _counts(want, REF_PEAKS),
                               **EXACT)
    assert set(got.as_dict()) == set(want.as_dict())
    for k in ("flops", "int_ops", "bytes_hbm", "bytes_coll", "coll_breakdown"):
        assert got.as_dict()[k] == want.as_dict()[k]
    # dominant / t_bound follow the port's own peaks
    times = {"compute": got.t_compute, "int": got.t_int, "memory": got.t_memory,
             "collective": got.t_collective}
    assert got.dominant == max(times, key=times.get)
    assert got.t_bound == max(times.values())


@pytest.mark.parametrize("trips", [0, 1, 7])
def test_combine_extrapolated_and_subtract_match_reference(trips):
    (a, ja), (b, jb) = _pair(TERMS[0]), _pair(TERMS[1])
    for got, want in ((an.combine_extrapolated(a, b, trips),
                       j_an.combine_extrapolated(ja, jb, trips)),
                      (an.subtract(a, b), j_an.subtract(ja, jb)),
                      (an.subtract(b, a), j_an.subtract(jb, ja))):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("path", ["int8", "xnor", "float"])
@pytest.mark.parametrize("m,n_in,r", [(1, 4096, 512), (32, 80, 24), (7, 33, 5)])
def test_integer_dense_ops_matches_reference(path, m, n_in, r):
    assert an.integer_dense_ops(m, n_in, r, path) == j_an.integer_dense_ops(
        m, n_in, r, path)


def test_integer_dense_ops_rejects_unknown_path():
    with pytest.raises(ValueError):
        an.integer_dense_ops(1, 32, 1, "fp8")


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ["granite-8b", "qwen2-moe-a2.7b", "mamba2-370m"])
def test_model_flops_matches_reference(arch, shape):
    n = 1_234_567_891
    assert an.model_flops(get_config(arch), SHAPES[shape], n) == j_an.model_flops(
        j_get_config(arch), J_SHAPES[shape], n)


def test_hw_picks_the_card_by_its_name():
    assert hw.card("NVIDIA H100 80GB HBM3") is hw.CARDS["SXM"]
    assert hw.card("NVIDIA H100 PCIe") is hw.CARDS["PCIe"]
    assert hw.card("NVIDIA H100 NVL") is hw.CARDS["NVL"]
    assert hw.HBM_BYTES == 80e9 and hw.LINK_BW == 50e9   # between nodes
    assert hw.SXM.peak("bf16") == hw.PEAK_FLOPS_BF16 == 989e12


# ---------------------------------------------------------------------------
# kernel_terms = the bound formulas chip_smoke.py used inline until now
# ---------------------------------------------------------------------------
def _t(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kernel,m", [("B1", 1), ("B1", 4), ("B1", 32),
                                      ("B2", 33), ("B2", 128), ("B2", 2048)])
@pytest.mark.parametrize("k,r", [(4096, 512), (4096, 128), (4096, 1792),
                                 (14336, 512), (1024, 256)])
def test_float_kernel_terms_equal_the_inline_bound(kernel, m, k, r, dtype):
    x, packed = _t((m, k), dtype), _t((r, k // 32), torch.int32)
    work = an.kernel_terms(kernel, x.shape, packed.shape, dtype)
    nbytes = x.numel() * x.element_size() + packed.numel() * 4 + m * r * 4
    flops = 2.0 * m * k * r
    assert (work.ops, work.bytes) == (flops, nbytes)
    card = hw.SXM
    peak = card.bf16 if dtype == torch.bfloat16 else card.f32
    t_bytes, t_ops = 1e3 * nbytes / card.hbm_bw, 1e3 * flops / peak
    assert work.times_ms(card) == (t_bytes, t_ops)
    assert work.bound_ms(card)[0] == max(t_bytes, t_ops)


@pytest.mark.parametrize("path", ["xnor", "int8"])
@pytest.mark.parametrize("m", [1, 4, 32])
@pytest.mark.parametrize("n_in,r", [(4096, 512), (14336, 512), (1024, 2048)])
def test_int_kernel_terms_equal_the_inline_bound(path, m, n_in, r):
    words = n_in // 32
    a = (_t((m, words), torch.int32) if path == "xnor"
         else _t((m, words * 32), torch.int8))
    packed = _t((r, words), torch.int32)
    work = an.kernel_terms("B3" if path == "xnor" else "B4", a.shape,
                           packed.shape, a.dtype)
    nbytes = a.numel() * a.element_size() + packed.numel() * 4 + m * r * 4
    ops = 2.0 * m * r * (words if path == "xnor" else n_in)
    assert (work.ops, work.bytes, work.peak) == (ops, nbytes, "int8")
    assert ops == an.integer_dense_ops(m, n_in, r, path)
    t_bytes, t_ops = 1e3 * nbytes / hw.SXM.hbm_bw, 1e3 * ops / hw.SXM.int8
    assert work.bound_ms()[0] == max(t_bytes, t_ops)


@pytest.mark.parametrize("with_a", [False, True])
@pytest.mark.parametrize("p,q", [(8, 4096 * 4096 // 8), (8, 1024 * 4096 // 8),
                                 (8, 14336 * 4096 // 8), (8, 49152 * 4096 // 8)])
def test_b5_kernel_terms_equal_the_inline_bound(p, q, with_a):
    work = an.kernel_terms("B5", (p, q), None, torch.float32, with_a=with_a)
    nbytes = p * q * 4 * (2 if with_a else 1) + q // 8 + p * 4
    assert work.bytes == nbytes
    assert work.bound_ms() == (1e3 * nbytes / hw.SXM.hbm_bw, "bytes")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [1, 64])
@pytest.mark.parametrize("h,c,r,stride", [(28, 128, 128, 2), (14, 256, 128, 1),
                                          (14, 256, 256, 2), (7, 512, 256, 1)])
def test_b6_kernel_terms_equal_the_inline_bound(n, h, c, r, stride, dtype):
    oh = -(-h // stride)
    hp = (oh - 1) * stride + 3
    x, packed = _t((n, hp, hp, c), dtype), _t((9, r, c // 32), torch.int32)
    work = an.kernel_terms("B6", x.shape, packed.shape, dtype, out_hw=(oh, oh))
    m = n * oh * oh
    nbytes = x.numel() * x.element_size() + packed.numel() * 4 + m * r * 4
    flops = 2.0 * m * 9 * c * r
    assert (work.ops, work.bytes) == (flops, nbytes)


def test_kernel_terms_rejects_unknown_kernel():
    with pytest.raises(ValueError):
        an.kernel_terms("B7", (1, 32), (1, 1))


# ---------------------------------------------------------------------------
# the dispatch-mode counter
# ---------------------------------------------------------------------------
def test_cost_counter_counts_aten_flops_bytes_kernels_and_peak():
    x = _t((64, 256), torch.float32)
    w = _t((128, 256), torch.float32)
    packed = _t((96, 8), torch.int32)
    xb = _t((40, 256), torch.bfloat16)
    before = tiled_matmul_unique.launches
    counter = an.CostCounter()
    with counter:
        y = x @ w.T                               # (64, 128)
        z = torch.relu(y)
        u = tiled_matmul_unique(xb, packed)       # B2 on meta: counted, no launch
        del y
    assert tiled_matmul_unique.launches == before
    assert u.shape == (40, 96) and z.shape == (64, 128)
    b2 = an.kernel_terms("B2", (40, 256), (96, 8), torch.bfloat16)
    assert counter.kernels == {"B2": 1}
    assert counter.flops == 2.0 * 64 * 256 * 128 + b2.ops
    mm_bytes = (64 * 256 + 128 * 256 + 64 * 128) * 4
    relu_bytes = 2 * 64 * 128 * 4
    assert counter.bytes_hbm == mm_bytes + relu_bytes + b2.bytes
    # y and z alive together, then u beside z (y dropped)
    assert counter.peak_bytes == 2 * 64 * 128 * 4 + 40 * 96 * 4
    assert counter.live_bytes == 64 * 128 * 4 + 40 * 96 * 4
    terms = counter.terms()
    assert terms.flops == counter.flops and terms.bytes_coll == 0.0
