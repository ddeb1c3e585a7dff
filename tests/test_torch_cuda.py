"""Kernels B1-B6 on the card against their plain PyTorch versions, the
paths around them card against CPU (the MoE serve layer, the SSM and
RG-LRU steps and the sliding-window ring among them), and the engine's
ticks replayed from CUDA graphs (``BatchedEngine.warmup``) against its
eager ticks, for the dense, MoE, SSM and hybrid families.

Imports neither jax nor the JAX package, so it runs on the GPU machine:

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports jax). Every test is marked
``cuda`` and skips, from a fixture, on a host without a CUDA device.
"""
import pytest
import torch

from repro_torch.core.packing import pack_bits, pack_conv_tile
from repro_torch.core.policy import tbn_policy
from repro_torch.core.tiling import plan_tiling
from repro_torch.kernels import ops
from repro_torch.kernels import tiled_xnor as x8
from repro_torch.kernels.tiled_conv import (
    CONV_BODIES,
    tiled_conv_body,
    tiled_conv_plain,
    tiled_conv_unique,
)
from repro_torch.kernels.tile_construct import (
    tile_construct_kernel,
    tile_construct_plain,
)
from repro_torch.kernels.tiled_matmul import (
    BODIES,
    tiled_matmul_body,
    tiled_matmul_plain,
    tiled_matmul_unique,
)
from repro_torch.kernels.tiled_matvec import (
    MATVEC_MAX_M,
    MV_BODIES,
    tiled_matvec_body,
    tiled_matvec_plain,
    tiled_matvec_unique,
)

torch.set_num_threads(2)
RTOL = 1e-4      # x*±1 is exact in f32: only the summation order differs


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (kernels B1-B6 have no CPU mode)")
    return torch.device("cuda")


def _operands(device, m, k, r, dtype, seed):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device=device).to(dtype)
    packed = torch.randint(0, 2**32, (r, k // 32), generator=gen, device=device,
                           dtype=torch.int64).to(torch.int32)
    return x, packed


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,r", [(1, 32, 1), (4, 96, 130), (17, 160, 65),
                                   (32, 4096, 512), (33, 96, 24),
                                   (128, 4096, 200), (200, 160, 64),
                                   (128, 14336, 512), (2048, 4096, 128),
                                   (2048, 4096, 1792), (130, 96, 130),
                                   (65, 160, 100)])
def test_kernel_matches_plain(cuda_device, m, k, r, dtype):
    """B1 (m <= 32) or B2 with the planner's body; B2 twice, equal (the
    split-K pass adds in a fixed order)."""
    x, packed = _operands(cuda_device, m, k, r, dtype, m * k + r)
    fn, plain = ((tiled_matvec_unique, tiled_matvec_plain) if m <= MATVEC_MAX_M
                 else (tiled_matmul_unique, tiled_matmul_plain))
    before = fn.launches
    got = fn(x, packed)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(x, packed)
    torch.testing.assert_close(got, want, rtol=RTOL,
                               atol=RTOL * float(want.abs().max()))
    if fn is tiled_matmul_unique:
        assert torch.equal(fn(x, packed), got)


@pytest.mark.cuda
@pytest.mark.parametrize("body", sorted(BODIES))
@pytest.mark.parametrize("m,k,r", [
    (2048, 4096, 128),      # train step k/v: split K
    (2048, 4096, 1792),     # train step gate/up: 256-filter tiles, no split
    (128, 14336, 512),      # extend tick, down: long K, many splits
    (130, 96, 130),         # ragged m and r, 3 words (odd)
    (65, 160, 100),         # ragged m and r, 5 words (odd)
    (40, 32, 1),            # one word, one filter
    (64, 512, 500)])        # the ResNet-34 head
def test_matmul_body_matches_plain(cuda_device, body, m, k, r):
    """Every bf16 body of B2, forced, against the plain version; twice,
    equal (deterministic)."""
    x, packed = _operands(cuda_device, m, k, r, torch.bfloat16, m + k + r)
    got = tiled_matmul_body(x, packed, body)
    torch.cuda.synchronize()
    want = tiled_matmul_plain(x, packed)
    torch.testing.assert_close(got, want, rtol=RTOL,
                               atol=RTOL * float(want.abs().max()))
    assert torch.equal(tiled_matmul_body(x, packed, body), got)


# Ragged decode shapes for the forced B1 / B4 bodies: m in {1, 3, 4, 8, 9,
# 17, 32} (n-tiles of 8 rows, part filled), r not a multiple of 16, 32 or
# 64 filters, words odd or not a multiple of 4, one word, more words than
# a staged chunk (16), and the full-width lm_head and down shapes.
MATVEC_CASES = [(1, 32, 1), (3, 96, 130), (4, 160, 65), (8, 4096, 200),
                (9, 1568, 100), (17, 544, 24), (32, 96, 130), (32, 14336, 512),
                (32, 4096, 6144), (1, 4096, 128), (9, 14336, 48)]


@pytest.mark.cuda
@pytest.mark.parametrize("body", sorted(MV_BODIES))
@pytest.mark.parametrize("m,k,r", MATVEC_CASES)
def test_matvec_body_matches_plain(cuda_device, body, m, k, r):
    """Every body of B1, forced, against the plain version (bf16; f32 on
    the CUDA-core body); twice, equal (the split pass adds in a fixed
    order)."""
    for dtype in (torch.bfloat16, torch.float32):
        if dtype == torch.float32 and body != "simt":
            continue
        x, packed = _operands(cuda_device, m, k, r, dtype, 7 * m + k + r)
        before = tiled_matvec_unique.launches
        got = tiled_matvec_body(x, packed, body)
        torch.cuda.synchronize()
        assert tiled_matvec_unique.launches == before + 1
        want = tiled_matvec_plain(x, packed)
        torch.testing.assert_close(got, want, rtol=RTOL,
                                   atol=RTOL * float(want.abs().max()))
        assert torch.equal(tiled_matvec_body(x, packed, body), got)


@pytest.mark.cuda
@pytest.mark.parametrize("body", sorted(x8.INT8_BODIES))
@pytest.mark.parametrize("m,k,r", MATVEC_CASES)
def test_int8_body_matches_plain_exactly(cuda_device, body, m, k, r):
    """Every body of B4, forced, against the plain version: int32
    accumulators equal, and equal again on a second run (the split
    blocks' atomic adds are exact in any order)."""
    a, rows = _int_operands(cuda_device, "int8", m, k, r, 11 * m + k + r)
    before = x8.tiled_int8_matvec_unique.launches
    got = x8.tiled_int8_body(a, rows, body)
    torch.cuda.synchronize()
    assert x8.tiled_int8_matvec_unique.launches == before + 1
    want = x8.int8_matvec_packed(a, rows, n_in=a.shape[1])
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(x8.tiled_int8_body(a, rows, body), got)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 128])
def test_tiled_dense_infer_on_card_matches_cpu(cuda_device, m):
    """The dispatch, padding (n_in = 80) and alpha broadcast around the
    kernels, card against CPU (plain versions) on the same inputs."""
    spec = plan_tiling((4 * 24, 80), p=4, min_size=1, alpha_source="W")
    x, packed = _operands(cuda_device, m, 96, 24, torch.float32, m)
    x = x[:, :80].contiguous()
    alpha = torch.rand(4, device=cuda_device) + 0.1
    got = ops.tiled_dense_infer(x, packed, alpha, spec)
    want = ops.tiled_dense_infer(x.cpu(), packed.cpu(), alpha.cpu(), spec)
    torch.testing.assert_close(got.cpu(), want, rtol=RTOL,
                               atol=RTOL * float(want.abs().max()))


def _int_operands(device, path, m, n_in, r, seed):
    """Quantized activations and a tile packed with ``pack_bits`` (pad bits
    0 on both operands when 32 does not divide n_in)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.randn((m, n_in), generator=gen, device=device)
    t = torch.randn((r, n_in), generator=gen, device=device)
    rows = pack_bits(t)
    if path == "xnor":
        return x8.quantize_sign(x, n_in)[0], rows
    q = x8.quantize_int8(x, n_in)[0]
    return torch.nn.functional.pad(q, (0, rows.shape[1] * 32 - n_in)), rows


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["xnor", "int8"])
@pytest.mark.parametrize("m,n_in,r", [(1, 32, 1), (4, 80, 24), (3, 96, 130),
                                      (17, 160, 65), (32, 4096, 512),
                                      (4, 14336, 512), (4, 4096, 6144)])
def test_int_kernel_matches_plain_exactly(cuda_device, path, m, n_in, r):
    a, rows = _int_operands(cuda_device, path, m, n_in, r, m * n_in + r)
    if path == "xnor":
        fn = x8.tiled_xnor_matvec_unique
        call = lambda: fn(a, rows, n_in=n_in)
        want = x8.xnor_matvec_words(a, rows, n_in=n_in)
    else:
        fn = x8.tiled_int8_matvec_unique
        call = lambda: fn(a, rows)
        want = x8.int8_matvec_packed(a, rows, n_in=a.shape[1])
    before = fn.launches
    got = call()
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, want)


# B3's forced bodies: the cases of test_int_kernel_matches_plain_exactly,
# then ragged steps of 8 words: n_in not a multiple of 256, words not a
# multiple of 8 (10, 65: the last step zero-filled) or of 4 (the 4-byte
# staging path), r = 1.
XNOR_CASES = [(1, 32, 1), (4, 80, 24), (3, 96, 130), (17, 160, 65),
              (32, 4096, 512), (4, 14336, 512), (4, 4096, 6144),
              (9, 300, 24), (32, 1000, 130), (5, 2080, 65), (24, 14336, 1)]
XNOR_VARIANTS = [("popc", None)] + [(b, red) for b in sorted(x8.XNOR_BODIES)
                                    if b != "popc" for red in x8.XNOR_REDUCE]


@pytest.mark.cuda
@pytest.mark.parametrize("body,reduce", XNOR_VARIANTS)
@pytest.mark.parametrize("m,n_in,r", XNOR_CASES)
def test_xnor_body_matches_plain_exactly(cuda_device, body, reduce, m, n_in, r):
    """Every body of B3, forced, with K whole in a block, and split and
    added in a cluster, against the plain version: int32 accumulators
    equal, and equal again on a second run. A variant the shape has not (K
    of one step cannot split; K too long for one block) is refused."""
    a, rows = _int_operands(cuda_device, "xnor", m, n_in, r, 13 * m + n_in + r)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plans = x8.xnor_plans(m, r, rows.shape[1], sms, body)
    if body != "popc" and reduce not in {p.reduce for p in plans}:
        with pytest.raises(ValueError, match="has no"):
            x8.tiled_xnor_body(a, rows, body, n_in=n_in, reduce=reduce)
        return
    before = x8.tiled_xnor_matvec_unique.launches
    got = x8.tiled_xnor_body(a, rows, body, n_in=n_in, reduce=reduce)
    torch.cuda.synchronize()
    assert x8.tiled_xnor_matvec_unique.launches == before + 1
    want = x8.xnor_matvec_words(a, rows, n_in=n_in)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(x8.tiled_xnor_body(a, rows, body, n_in=n_in, reduce=reduce), got)


# the (K, r) of qwen1.5-32b, starcoder2-7b and minitron-8b that granite-8b
# has not (tests/test_torch_matvec_plan.py)
DENSE_FAMILY = ((5120, 640), (5120, 3424), (27392, 640), (5120, 19008),
                (4608, 576), (4608, 64), (4608, 2304), (18432, 576),
                (4608, 6144), (4096, 2048), (16384, 512), (4096, 32000))


# the (K, r) of mamba2-370m and recurrentgemma-2b
# (tests/test_torch_matvec_plan.py); r = 1096 and 12570 are not multiples
# of 16
SSM_HYBRID = ((1024, 1096), (2048, 256), (1024, 12570), (2560, 320),
              (2560, 32), (2560, 960), (7680, 320), (2560, 32000))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["B1", "B2", "B3", "B4"])
@pytest.mark.parametrize("k,r", DENSE_FAMILY)
def test_dense_family_shapes_match_plain(cuda_device, kernel, k, r):
    """The planners' picks at the new (K, r) of the dense family against the
    plain version: B1 (bf16 and f32) at m in {1, 4, 32} and B2 at m in {33,
    128} within RTOL, B3 / B4 at m in {1, 4, 32} exactly."""
    _check_picks_against_plain(cuda_device, kernel, k, r)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["B1", "B2", "B3", "B4"])
@pytest.mark.parametrize("k,r", SSM_HYBRID)
def test_ssm_hybrid_shapes_match_plain(cuda_device, kernel, k, r):
    """The same at the (K, r) of mamba2-370m and recurrentgemma-2b."""
    _check_picks_against_plain(cuda_device, kernel, k, r)


def _check_picks_against_plain(cuda_device, kernel, k, r):
    if kernel in ("B1", "B2"):
        fn, plain = ((tiled_matvec_unique, tiled_matvec_plain) if kernel == "B1"
                     else (tiled_matmul_unique, tiled_matmul_plain))
        for m in ((1, 4, 32) if kernel == "B1" else (33, 128)):
            for dtype in (torch.bfloat16, torch.float32):
                x, packed = _operands(cuda_device, m, k, r, dtype, m + k + r)
                got = fn(x, packed)
                want = plain(x, packed)
                torch.testing.assert_close(got, want, rtol=RTOL,
                                           atol=RTOL * float(want.abs().max()))
        return
    path = "xnor" if kernel == "B3" else "int8"
    for m in (1, 4, 32):
        a, rows = _int_operands(cuda_device, path, m, k, r, m * k + r)
        if path == "xnor":
            got = x8.tiled_xnor_matvec_unique(a, rows, n_in=k)
            want = x8.xnor_matvec_words(a, rows, n_in=k)
        else:
            got = x8.tiled_int8_matvec_unique(a, rows)
            want = x8.int8_matvec_packed(a, rows, n_in=k)
        assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [9, 32])
def test_xnor_past_every_tensor_core_plan_takes_popc(cuda_device, m):
    """A K too long for a cluster of splits in shared memory: the planner
    falls back to "popc" past its row limit, and the result is exact."""
    from repro_torch.kernels.tiled_matvec import max_split_words

    words = x8.XNOR_CLUSTER * max_split_words(m, 16, 4, x8.XNOR_STEP, True) + x8.XNOR_STEP
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert x8.plan_xnor(m, 40, words, sms).body == "popc"
    a, rows = _int_operands(cuda_device, "xnor", m, words * 32 - 5, 40, m + words)
    got = x8.tiled_xnor_matvec_unique(a, rows, n_in=words * 32 - 5)
    assert torch.equal(got, x8.xnor_matvec_words(a, rows, n_in=words * 32 - 5))


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["xnor", "int8"])
@pytest.mark.parametrize("m", [4, 33])
def test_int_paths_on_card_match_cpu(cuda_device, path, m):
    """Quantize, B3/B4 (m = 4) or B2 (m = 33), scale and alpha broadcast,
    card against CPU on the same inputs (n_in = 80: pad bits). The int32
    accumulators are equal; the f32 scale mean|x| may differ in its last
    bits by summation order, hence rtol 1e-5."""
    spec = plan_tiling((4 * 24, 80), p=4, min_size=1, alpha_source="W")
    _, rows = _int_operands(cuda_device, path, 1, 80, 24, m)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(m)
    x = torch.randn((m, 80), generator=gen, device=cuda_device)
    alpha = torch.rand(4, device=cuda_device) + 0.1
    got = ops.tiled_dense_infer(x, rows, alpha, spec, compute_path=path)
    want = ops.tiled_dense_infer(x.cpu(), rows.cpu(), alpha.cpu(), spec,
                                 compute_path=path)
    rtol = 1e-5 if m <= 32 else RTOL
    torch.testing.assert_close(got.cpu(), want, rtol=rtol,
                               atol=rtol * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["W", "A"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p,q", [(1, 32), (3, 96), (8, 4096), (4, 8192),
                                 (8, 3 * 2048 + 32), (2, 64 * 2048)])
def test_tile_construct_kernel_matches_plain(cuda_device, p, q, dtype, source):
    """B5: the packed words are exactly the plain version's (both add the
    p rows in the same order in f32); alpha to rtol 1e-5 (|.| sums in
    another order)."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(p * q)
    w = torch.randn((p, q), generator=gen, device=cuda_device).to(dtype)
    a = (torch.randn((p, q), generator=gen, device=cuda_device).to(dtype)
         if source == "A" else None)
    before = tile_construct_kernel.launches
    got_w, got_a = tile_construct_kernel(w, a)
    torch.cuda.synchronize()
    assert tile_construct_kernel.launches == before + 1
    want_w, want_a = tile_construct_plain(w, a)
    assert got_w.dtype == torch.int32 and torch.equal(got_w, want_w)
    torch.testing.assert_close(got_a, want_a, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("alpha_source", ["W", "A"])
@pytest.mark.parametrize("alpha_mode", ["layer", "tile"])
def test_tile_construct_on_card_matches_cpu(cuda_device, alpha_source, alpha_mode):
    """ops.tile_construct around B5: q = 500 pads to 512, the alpha
    rescale and the layer mean, card against CPU."""
    spec = plan_tiling((40, 50), p=4, min_size=1, alpha_mode=alpha_mode,
                       alpha_source=alpha_source)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(3)
    w = torch.randn((40, 50), generator=gen, device=cuda_device)
    a = torch.randn((40, 50), generator=gen, device=cuda_device)
    got = ops.tile_construct(w, spec, a=a)
    want = ops.tile_construct(w.cpu(), spec, a=a.cpu())
    assert torch.equal(got[0].cpu(), want[0])
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 96])
def test_tbn_dense_train_on_card_matches_cpu(cuda_device, m):
    """The fused training forward (B5, then B1 at m=4 or B2 at m=96) and
    its gradient, card against CPU, f32."""
    spec = plan_tiling((4 * 24, 64), p=4, min_size=1, alpha_source="W")
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(m)
    x0 = torch.randn((m, 64), generator=gen, device=cuda_device)
    w0 = torch.randn((96, 64), generator=gen, device=cuda_device)
    g0 = torch.randn((m, 96), generator=gen, device=cuda_device)
    out = {}
    for dev in ("cuda", "cpu"):
        x = x0.to(dev).clone().requires_grad_()
        w = w0.to(dev).clone().requires_grad_()
        y = ops.tbn_dense_train(x, w, w, spec)
        y.backward(g0.to(dev))
        out[dev] = (y.detach().cpu(), x.grad.cpu(), w.grad.cpu())
    for got, want in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=RTOL,
                                   atol=RTOL * float(want.abs().max()))


@pytest.mark.cuda
def test_fused_train_forward_on_card_matches_cpu(cuda_device):
    """The reduced model's fused train_forward and every gradient leaf,
    card (B5 + B1/B2) against CPU (plain versions), f32."""
    from repro_torch.configs import build_model, get_config
    from repro_torch.nn import module as mod
    from repro_torch.nn.context import TRAIN, ModelContext

    cfg = get_config("granite-8b").reduced()
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (2, 24), generator=gen)
    out = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, ModelContext(policy=cfg.tbn, mode=TRAIN,
                                              compute_dtype=torch.float32,
                                              device=dev, fused_train=True))
        params = mod.map_tree(lambda v: v.to(dev), build_model(
            cfg, ModelContext(policy=cfg.tbn, mode=TRAIN, device="cpu")).init(0))
        leaves = [v.requires_grad_() for _, v in mod.walk(params)]
        loss, _ = model.train_forward(params, {"tokens": tokens})
        grads = torch.autograd.grad(loss, leaves)
        out[dev] = (loss.detach().cpu(), [g.cpu() for g in grads])
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4, atol=0)
    for got, want in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(got, want, rtol=1e-3,
                                   atol=1e-3 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,hw,c,r,k,s", [
    (1, 30, 128, 128, 3, 2),    # ResNet-34 stage-2 entry, N = 1 (split K)
    (2, 16, 256, 128, 3, 1),    # stage 2
    (1, 9, 512, 256, 3, 1),     # stage 3, N = 1: 4 output tiles
    (3, 11, 64, 100, 3, 2),     # ragged M and r
    (2, 8, 64, 512, 1, 2),      # 1x1 stride-2 downsample
    (1, 7, 32, 1, 1, 1),
    (64, 30, 128, 128, 3, 2),   # ResNet-34's four tiled shapes at N = 64
    (64, 16, 256, 128, 3, 1),
    (64, 16, 256, 256, 3, 2),
    (64, 9, 512, 256, 3, 1),
    (2, 9, 32, 40, 3, 1),       # C = 32: one word per kernel position
    (2, 9, 96, 40, 3, 1)])      # 3 words: a stage with one word missing
def test_conv_kernel_matches_plain(cuda_device, dtype, n, hw, c, r, k, s):
    """B6 on pre-padded NHWC input against its plain version (rtol 1e-4,
    atol 1e-4 * max|u|: x * ±1 is exact, only the sum order differs)."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(n * hw + c + r)
    x = torch.randn((n, hw, hw, c), generator=gen, device=cuda_device).to(dtype)
    packed = torch.randint(0, 2**32, (k * k, r, c // 32), generator=gen,
                           device=cuda_device, dtype=torch.int64).to(torch.int32)
    o = (hw - k) // s + 1
    kw = dict(kernel=(k, k), stride=(s, s), out_hw=(o, o))
    before = tiled_conv_unique.launches
    got = tiled_conv_unique(x, packed, **kw)
    torch.cuda.synchronize()
    assert tiled_conv_unique.launches == before + 1
    want = tiled_conv_plain(x, packed, **kw)
    torch.testing.assert_close(got, want, rtol=RTOL,
                               atol=RTOL * float(want.abs().max()))
    again = tiled_conv_unique(x, packed, **kw)
    assert torch.equal(again, got)          # fixed-order split-K pass


@pytest.mark.cuda
@pytest.mark.parametrize("body", CONV_BODIES)
@pytest.mark.parametrize("n,hw,c,r,k,s", [
    (1, 30, 128, 128, 3, 2), (1, 9, 512, 256, 3, 1), (64, 16, 256, 128, 3, 1),
    (3, 11, 64, 100, 3, 2), (2, 9, 32, 40, 3, 1), (2, 9, 96, 40, 3, 1),
    (2, 8, 64, 512, 1, 2)])
def test_conv_body_matches_plain(cuda_device, body, n, hw, c, r, k, s):
    """Every bf16 body of B6, forced, against the plain version; twice,
    equal."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(n + hw + c + r)
    x = torch.randn((n, hw, hw, c), generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    packed = torch.randint(0, 2**32, (k * k, r, c // 32), generator=gen,
                           device=cuda_device, dtype=torch.int64).to(torch.int32)
    o = (hw - k) // s + 1
    kw = dict(kernel=(k, k), stride=(s, s), out_hw=(o, o))
    got = tiled_conv_body(x, packed, body, **kw)
    torch.cuda.synchronize()
    want = tiled_conv_plain(x, packed, **kw)
    torch.testing.assert_close(got, want, rtol=RTOL,
                               atol=RTOL * float(want.abs().max()))
    assert torch.equal(tiled_conv_body(x, packed, body, **kw), got)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["c48", "down1x1", "k53", "same_lower",
                                  "pairs", "layer", "tile"])
def test_tiled_conv_infer_on_card_matches_cpu(cuda_device, case):
    """tiled_conv_infer's padding (channels to whole words, asymmetric
    SAME), replica broadcast and alpha modes around B6, card against
    CPU, f32."""
    c_out, c_in, kh, kw, p = 64, 32, 3, 3, 2
    stride, padding, mode, hw = (1, 1), "SAME", "tile", (12, 12)
    if case == "c48":
        c_in = 48
    elif case == "down1x1":
        c_out, c_in, kh, kw, p, stride = 512, 256, 1, 1, 8, (2, 2)
    elif case == "k53":
        kh, kw, stride, padding, hw = 5, 3, (1, 2), "VALID", (12, 11)
    elif case == "same_lower":
        stride, padding = (2, 2), "SAME_LOWER"
    elif case == "pairs":
        padding = [(2, 1), (0, 2)]
    elif case == "layer":
        mode, stride = "layer", (2, 2)
    spec = plan_tiling((c_out, c_in, kh, kw), p=p, min_size=0, alpha_mode=mode)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(c_in + kh)
    x = torch.randn((2, *hw, c_in), generator=gen, device=cuda_device)
    t = torch.randn((spec.q,), generator=gen, device=cuda_device)
    packed = pack_conv_tile(t, c_out // p, c_in, kh, kw)
    alpha = torch.rand((spec.n_alpha,), generator=gen, device=cuda_device) + 0.1
    before = tiled_conv_unique.launches
    got = ops.tiled_conv_infer(x, packed, alpha, spec, stride=stride,
                               padding=padding)
    assert tiled_conv_unique.launches == before + 1
    want = ops.tiled_conv_infer(x.cpu(), packed.cpu(), alpha.cpu(), spec,
                                stride=stride, padding=padding)
    torch.testing.assert_close(got.cpu(), want, rtol=RTOL,
                               atol=RTOL * float(want.abs().max()))


@pytest.mark.cuda
def test_resnet34_imagenet_serve_on_card_matches_cpu(cuda_device):
    """A cut ResNet-34 ImageNet (width 8, lambda 2000, 64 x 64 input): SERVE
    logits card (B6, B1, cuDNN for the BWNN convs) against CPU, f32."""
    from repro_torch.models.paper import build_paper_model
    from repro_torch.nn import module as mod
    from repro_torch.nn.context import SERVE, TRAIN, ModelContext
    from repro_torch.serve.weights import export_serving_params

    torch.backends.cudnn.allow_tf32 = False
    pol = tbn_policy(p=2, min_size=2000)
    kw = dict(width=8, imagenet=True, classes=1000)
    tm = build_paper_model("resnet34", ModelContext(policy=pol, mode=TRAIN,
                                                    device="cpu"), **kw)
    models = {dev: build_paper_model("resnet34", ModelContext(
        policy=pol, mode=SERVE, compute_dtype=torch.float32, device=dev), **kw)
        for dev in ("cuda", "cpu")}
    sp = export_serving_params(tm.specs(), models["cpu"].specs(), tm.init(0), pol)
    x = torch.randn((2, 64, 64, 3), generator=torch.Generator().manual_seed(0))
    before = tiled_conv_unique.launches
    with torch.no_grad():
        got = models["cuda"](mod.map_tree(lambda v: v.cuda(), sp), x.cuda())
        want = models["cpu"](sp, x)
    n_tiled = sum(1 for path, _ in mod.walk(sp) if path[-1] == "tile_conv")
    assert n_tiled == 26 and tiled_conv_unique.launches - before == n_tiled
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)


def _reduced_serving(arch, path):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_serving

    cfg = get_config(arch).reduced()
    model, sp, _ = build_serving(cfg, device="cuda", seed=0, compute_path=path)
    return cfg, model, sp


def _warm_engine_case(model, sp, path):
    from repro_torch.serve.engine import BatchedEngine, ServeConfig

    return BatchedEngine(model, sp, ServeConfig(
        n_slots=2, max_len=48, chunk_tokens=8, page_tokens=8, compute_path=path))


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["float", "xnor", "int8"])
@pytest.mark.parametrize("arch", ["granite-8b", "qwen1.5-32b", "qwen2-moe-a2.7b",
                                  "moonshot-v1-16b-a3b"])
def test_warm_engine_replays_cold_tokens_on_card(cuda_device, arch, path):
    """A reduced engine in bf16 on the card, cold and then warm (decode and
    extend ticks replayed from CUDA graphs) on one export: equal greedy
    tokens, token steps and ticks; in the warm drain neither the kernel
    wrappers' launch counters nor TRACE_COUNTS move; a second warmup() is a
    no-op (same graphs, same seconds, no capture)."""
    import numpy as np

    from repro_torch.serve.engine import TRACE_COUNTS
    from repro_torch.serve.sampling import SamplingParams

    cfg, model, sp = _reduced_serving(arch, path)
    wrappers = (tiled_matvec_unique, tiled_matmul_unique,
                x8.tiled_xnor_matvec_unique, x8.tiled_int8_matvec_unique,
                tile_construct_kernel, tiled_conv_unique)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in (5, 11, 19, 3)]
    runs = []
    for warm in (False, True):
        eng = _warm_engine_case(model, sp, path)
        if warm:
            timings = eng.warmup()
            graphs = dict(eng._graphs)
            traces = TRACE_COUNTS.copy()
            assert eng.warmup() == timings and TRACE_COUNTS == traces
            assert all(eng._graphs[k] is g and g.graph is not None
                       for k, g in graphs.items())
        launches = [fn.launches for fn in wrappers]
        traces = TRACE_COUNTS.copy()
        reqs = [eng.submit(p, SamplingParams(max_tokens=6)) for p in prompts]
        ticks = eng.run_until_drained()
        moved = [fn.launches - n for fn, n in zip(wrappers, launches)]
        if warm:
            assert moved == [0] * len(wrappers) and TRACE_COUNTS == traces
        else:
            assert sum(moved) > 0 and TRACE_COUNTS != traces
        assert eng.stats()["aot_warm"] is warm
        runs.append(([r.output for r in reqs], [r.token_steps for r in reqs], ticks))
    assert runs[0] == runs[1]


@pytest.mark.cuda
@pytest.mark.parametrize("method,entry", [("decode_step", "decode_tick"),
                                          ("extend", "extend_tick")])
def test_failed_capture_raises_on_card(cuda_device, method, entry):
    """A tick function that raises during warmup on a CUDA engine: a
    RuntimeError naming the entry point and its shapes, and the engine stays
    cold (it never falls back to eager ticks quietly)."""
    _, model, sp = _reduced_serving("granite-8b", "float")

    def boom(*args, **kwargs):
        raise ValueError("no capture today")

    eng = _warm_engine_case(model, sp, "float")
    setattr(model, method, boom)
    with pytest.raises(RuntimeError, match=rf"'{entry}' \(.*int32\[2,6\].*no "
                                           rf"capture today"):
        eng.warmup()
    assert not eng.aot_warm


def _recording_moe(monkeypatch):
    """Record every MoE serve call's routing: (probs, expert ids, dispatch
    positions), in call order."""
    from repro_torch.nn import moe

    calls = []
    route, dispatch = moe.MoE._route, moe.MoE._dispatch_serve

    def rec_route(self, router, xg):
        out = route(self, router, xg)
        calls.append({"probs": out[0].cpu(), "ids": out[2].cpu()})
        return out

    def rec_dispatch(self, xg, top_idx):
        xbuf, meta = dispatch(self, xg, top_idx)
        calls[-1]["pos"] = meta[1].cpu()
        return xbuf, meta

    monkeypatch.setattr(moe.MoE, "_route", rec_route)
    monkeypatch.setattr(moe.MoE, "_dispatch_serve", rec_dispatch)
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "moonshot-v1-16b-a3b"])
@pytest.mark.parametrize("tokens", [(4, 1), (4, 16)])
def test_moe_serve_call_on_card_matches_cpu(cuda_device, monkeypatch, arch, tokens):
    """The reduced config's MoE layer in SERVE mode, f32, on a decode-sized
    (4 x 1) and an extend-sized (4 x 16) input: expert ids and dispatch
    positions equal card vs CPU, outputs at rtol = atol = 1e-5 (the shared
    experts run B1 / B2 on the card)."""
    from repro_torch.configs import get_config
    from repro_torch.nn import moe
    from repro_torch.nn.context import SERVE, TRAIN, ModelContext
    from repro_torch.nn import module as mod
    from repro_torch.serve.weights import export_serving_params

    torch.backends.cuda.matmul.allow_tf32 = True      # the router turns it off
    cfg = get_config(arch).reduced()
    m = cfg.moe

    def layer(mode, dev):
        ctx = ModelContext(policy=cfg.tbn, mode=mode, compute_dtype=torch.float32,
                           device=dev)
        return moe.MoE(cfg.d_model, m.d_ff_expert, m.n_experts, m.top_k, ctx,
                       n_shared=m.n_shared, activation=cfg.activation)

    tm = layer(TRAIN, "cpu")
    sp = export_serving_params(tm.specs(), layer(SERVE, "cpu").specs(),
                               mod.init_params(tm.specs(), 0, "cpu"), cfg.tbn)
    x = torch.randn((*tokens, cfg.d_model), generator=torch.Generator().manual_seed(1))
    calls = _recording_moe(monkeypatch)
    with torch.no_grad():
        got = layer(SERVE, "cuda")(mod.map_tree(lambda v: v.cuda(), sp), x.cuda())[0]
        want = layer(SERVE, "cpu")(sp, x)[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    card, cpu = calls
    assert torch.equal(card["ids"], cpu["ids"]) and torch.equal(card["pos"], cpu["pos"])
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["float", "xnor", "int8"])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "moonshot-v1-16b-a3b"])
def test_moe_decode_tick_launch_counts(cuda_device, arch, path):
    """One 2-slot decode tick of the reduced MoE config launches the path's
    decode kernel once per tiled projection: 4 attention projections and
    the 3 of the shared-expert MLP a layer (moonshot's dense0: its 3 MLP
    projections), 2 layers, and the LM head: 15. The routed experts launch
    no kernel (rebuilt banks, plain batched products), nor does B2."""
    import numpy as np

    from repro_torch.serve.sampling import SamplingParams

    cfg, model, sp = _reduced_serving(arch, path)
    eng = _warm_engine_case(model, sp, path)
    for n in (3, 5):
        eng.submit(np.arange(n), SamplingParams(max_tokens=4))
    eng.step()                                   # the extend tick
    own = {"float": tiled_matvec_unique, "xnor": x8.tiled_xnor_matvec_unique,
           "int8": x8.tiled_int8_matvec_unique}[path]
    wrappers = (tiled_matvec_unique, tiled_matmul_unique,
                x8.tiled_xnor_matvec_unique, x8.tiled_int8_matvec_unique)
    before = [fn.launches for fn in wrappers]
    eng.step()                                   # one decode-only tick
    torch.cuda.synchronize()
    moved = {fn: fn.launches - n for fn, n in zip(wrappers, before)}
    assert eng.stats()["decode_ticks"] == 1 and eng.stats()["extend_ticks"] == 1
    assert moved[own] == (4 + 3) * cfg.n_layers + 1
    assert all(v == 0 for fn, v in moved.items() if fn is not own)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["float", "xnor", "int8"])
@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-2b"])
def test_ssm_hybrid_warm_engine_replays_cold_tokens_on_card(cuda_device, arch, path):
    """The SSM and hybrid families in bf16 on the card, cold and then warm
    (decode tick, extend tick and slot reset replayed from CUDA graphs):
    no page pool; equal greedy tokens, token steps and ticks (prompts of up
    to 19 tokens wrap recurrentgemma's reduced 8-token window); the warm
    drain moves no launch counter and no TRACE_COUNTS, reset_slot
    included."""
    import numpy as np

    from repro_torch.serve.engine import TRACE_COUNTS
    from repro_torch.serve.sampling import SamplingParams

    cfg, model, sp = _reduced_serving(arch, path)
    wrappers = (tiled_matvec_unique, tiled_matmul_unique,
                x8.tiled_xnor_matvec_unique, x8.tiled_int8_matvec_unique)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in (5, 11, 19, 3)]
    runs = []
    for warm in (False, True):
        eng = _warm_engine_case(model, sp, path)
        assert eng.pool is None
        if warm:
            assert set(eng.warmup()) == {"decode_tick", "extend_tick", "reset_slot"}
        launches = [fn.launches for fn in wrappers]
        traces = TRACE_COUNTS.copy()
        reqs = [eng.submit(p, SamplingParams(max_tokens=6)) for p in prompts]
        ticks = eng.run_until_drained()
        moved = [fn.launches - n for fn, n in zip(wrappers, launches)]
        if warm:
            assert moved == [0] * len(wrappers) and TRACE_COUNTS == traces
        else:
            assert sum(moved) > 0 and TRACE_COUNTS["reset_slot"] > traces["reset_slot"]
        runs.append(([r.output for r in reqs], [r.token_steps for r in reqs], ticks))
    assert runs[0] == runs[1]


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["float", "xnor", "int8"])
@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-2b"])
def test_ssm_hybrid_decode_tick_launch_counts(cuda_device, arch, path):
    """One 2-slot decode tick launches the path's decode kernel once per
    tiled projection of every layer and the LM head, and no other kernel."""
    import numpy as np

    from repro_torch.nn import module as mod
    from repro_torch.serve.sampling import SamplingParams

    cfg, model, sp = _reduced_serving(arch, path)
    n_tiled = sum(v.shape[0] if v.ndim == 3 else 1
                  for p, v in mod.walk(sp) if p[-1] == "tile")
    eng = _warm_engine_case(model, sp, path)
    for n in (3, 5):
        eng.submit(np.arange(n), SamplingParams(max_tokens=4))
    eng.step()                                   # the extend tick
    own = {"float": tiled_matvec_unique, "xnor": x8.tiled_xnor_matvec_unique,
           "int8": x8.tiled_int8_matvec_unique}[path]
    wrappers = (tiled_matvec_unique, tiled_matmul_unique,
                x8.tiled_xnor_matvec_unique, x8.tiled_int8_matvec_unique)
    before = [fn.launches for fn in wrappers]
    eng.step()                                   # one decode-only tick
    torch.cuda.synchronize()
    moved = {fn: fn.launches - n for fn, n in zip(wrappers, before)}
    assert moved[own] == n_tiled
    assert all(v == 0 for fn, v in moved.items() if fn is not own)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-2b"])
def test_ssm_hybrid_model_on_card_matches_cpu(cuda_device, arch):
    """The reduced SERVE model in f32, card against CPU on one export: two
    slots stream 20- and 13-token prompts in chunks of 7 (recurrentgemma's
    8-token ring wraps), then three decode steps; logits and every cache
    leaf (carries, conv tails, ring rows) within 1e-4."""
    from repro_torch.configs import build_model, get_config
    from repro_torch.nn import module as mod
    from repro_torch.nn.context import SERVE, ModelContext
    from repro_torch.launch.serve import build_serving

    cfg = get_config(arch).reduced()
    _, sp, _ = build_serving(cfg, device="cpu", seed=0,
                             compute_dtype=torch.float32)
    gen = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen) for n in (20, 13)]
    out = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, ModelContext(policy=cfg.tbn, mode=SERVE,
                                              compute_dtype=torch.float32,
                                              device=dev))
        params = mod.map_tree(lambda v: v.to(dev), sp)
        caches = model.init_caches(2, 32, torch.float32)
        lengths = torch.zeros(2, dtype=torch.int32, device=dev)
        logits = []
        with torch.no_grad():
            for at in range(0, 20, 7):
                block = torch.zeros((2, 7), dtype=torch.long)
                n_new = torch.zeros(2, dtype=torch.int32)
                for s, p in enumerate(prompts):
                    seg = p[at:at + 7]
                    block[s, :len(seg)] = seg
                    n_new[s] = len(seg)
                lg, caches, lengths = model.extend(params, block.to(dev), caches,
                                                   lengths, n_new.to(dev))
                logits.append(lg[n_new.to(dev) > 0].cpu())
            tok = torch.tensor([[1], [2]], device=dev)
            for _ in range(3):
                lg, caches, lengths = model.decode_step(params, tok, caches, lengths)
                logits.append(lg.cpu())
        out[dev] = (logits, [v.cpu() for c in caches for _, v in mod.walk(c)])
    for got, want in zip(out["cuda"][0] + out["cuda"][1],
                         out["cpu"][0] + out["cpu"][1]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ssm", "rec"])
def test_mamba2_and_rglru_steps_on_card_match_cpu(cuda_device, kind):
    """One f32 mixer (TRAIN-mode weights: no kernel) at recurrentgemma's /
    mamba2's full widths, card against CPU: ``extend`` over 8 ragged
    columns from a random carry, then ``decode_step``, outputs and carries
    within 1e-4."""
    from repro_torch.nn import module as mod
    from repro_torch.nn.context import TRAIN, ModelContext
    from repro_torch.nn.rglru import RGLRUBlock
    from repro_torch.nn.ssm import Mamba2Block

    d = 1024 if kind == "ssm" else 2560
    res = {}
    for dev in ("cuda", "cpu"):
        gen = torch.Generator().manual_seed(3)
        ctx = ModelContext(mode=TRAIN, compute_dtype=torch.float32, device=dev)
        blk = Mamba2Block(d, ctx) if kind == "ssm" else RGLRUBlock(d, ctx)
        params = mod.init_params(blk.specs(), 0, "cpu")
        params = mod.map_tree(lambda v: v.to(dev), params)
        st = mod.map_tree(lambda v: v.to(dev), mod.map_tree(
            lambda v: 0.1 * torch.randn(v.shape, generator=gen),
            blk.init_state(3)))
        u = torch.randn((3, 8, d), generator=gen).to(dev)
        valid = (torch.arange(8)[None, :] < torch.tensor([8, 5, 0])[:, None]).to(dev)
        with torch.no_grad():
            y1, st = blk.extend(params, u, st, valid)
            y2, st = blk.decode_step(params, u[:, :1], st)
        res[dev] = [y1.cpu(), y2.cpu()] + [v.cpu() for _, v in mod.walk(st)]
    for got, want in zip(res["cuda"], res["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
