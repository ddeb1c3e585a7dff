"""Kernel B9 (``kernels/seq_attend.py``, ``csrc/seq_attend.cu``) on the
card against its plain version on the same inputs: the f64 partial
softmax (o, m, l) within 1e-12 x max|.|, and the one part rounded once to
f32 / bf16 equal to the plain version's but where a value lies within
1e-12 x max|o| of a rounding boundary (each such difference one step), at
the decode and extend shapes of qwen1.5-32b (K = 8, G = 5, hd = 128) and
starcoder2-7b (K = 4, G = 9), recurrentgemma-2b's ring (K = 1, G = 10, hd =
256) and a reduced width (hd = 16), over bf16 / f32 K/V and int8 codes
with scales, with causal masks at per-slot lengths and a row with no
valid key; and two parts of interleaved keys, each through the kernel,
merged as a mesh merges them, equal to the one part.

Imports neither jax nor the JAX package, so it runs on the GPU machine:

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_seq_attend_cuda.py

Every test is marked ``cuda`` and skips, from a fixture, on a host without
a CUDA device.
"""
import pytest
import torch

from repro_torch.distributed.sharding import merge_softmax_parts
from repro_torch.kernels.seq_attend import (
    near_rounding_boundary,
    seq_attend,
    seq_attend_plain,
)

TOL = 1e-12
# name -> (B, S, K, G, hd, T, K/V kind)
CASES = {
    "qwen decode bf16": (4, 1, 8, 5, 128, 320, "bf16"),
    "qwen decode int8": (4, 1, 8, 5, 128, 320, "int8"),
    "qwen extend int8": (4, 32, 8, 5, 128, 320, "int8"),
    "starcoder2 decode bf16": (4, 1, 4, 9, 128, 256, "bf16"),
    "starcoder2 extend f32": (2, 16, 4, 9, 128, 200, "f32"),
    "recurrentgemma ring bf16": (4, 1, 1, 10, 256, 2048, "bf16"),
    "reduced f32": (3, 8, 2, 2, 16, 64, "f32"),
    # a long view at short lengths: key splits whose keys are all masked
    "long view int8": (4, 1, 8, 5, 128, 4096, "int8"),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (kernel B9 has no CPU mode)")
    return torch.device("cuda", 0)


def make_inputs(case, dev, seed=0):
    """q, k, v, ks, vs, mask of a case: causal at per-slot lengths; the last
    slot's last query row attends no key."""
    b, s, kh, g, hd, t, kind = CASES[case]
    gen = torch.Generator().manual_seed(seed)
    cd = torch.float32 if kind == "f32" else torch.bfloat16
    q = torch.randn((b, s, kh, g, hd), generator=gen).to(cd)
    if kind == "int8":
        k = torch.randint(-127, 128, (b, t, kh, hd), generator=gen, dtype=torch.int8)
        v = torch.randint(-127, 128, (b, t, kh, hd), generator=gen, dtype=torch.int8)
        ks = torch.rand((b, t, kh), generator=gen) * 0.02 + 1e-3
        vs = torch.rand((b, t, kh), generator=gen) * 0.02 + 1e-3
    else:
        k = torch.randn((b, t, kh, hd), generator=gen).to(cd)
        v = torch.randn((b, t, kh, hd), generator=gen).to(cd)
        ks = vs = None
    lengths = torch.randint(s, t + 1, (b,), generator=gen)
    if t > 1024:
        lengths = torch.randint(s, 300, (b,), generator=gen)
    q_pos = lengths[:, None] - s + torch.arange(s)[None, :]
    mask = q_pos[:, :, None] >= torch.arange(t)[None, None, :]
    mask[-1, -1] = False
    out = [q, k, v, ks, vs, mask]
    return [None if x is None else x.to(dev) for x in out]


def _within(got, want, what):
    err = float((got - want).abs().max())
    assert err <= TOL * float(want.abs().max()) + 1e-300, (what, err)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_partials_match_the_plain_version(cuda_device, case):
    ins = make_inputs(case, cuda_device)
    scale = 1.0 / CASES[case][4] ** 0.5
    got = seq_attend(*ins, scale)
    torch.cuda.synchronize()
    want = seq_attend_plain(*ins, scale)
    live = ins[-1].any(-1)
    for name, g, w in zip("oml", got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape, name
        if name == "m":
            assert torch.equal(g[~live], w[~live])
            g, w = g[live], w[live]
        _within(g, w, name)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_one_part_rounds_as_the_plain_version(cuda_device, case):
    ins = make_inputs(case, cuda_device)
    dt = ins[0].dtype
    scale = 1.0 / CASES[case][4] ** 0.5
    got = seq_attend(*ins, scale, dt)[0]
    want = seq_attend_plain(*ins, scale, dt)[0]
    exact = seq_attend_plain(*ins, scale)
    ratio = merge_softmax_parts(torch.cat(
        [exact[0], exact[1][..., None], exact[2][..., None]], -1)[None])
    near = near_rounding_boundary(ratio, dt, TOL * float(ratio.abs().max()))
    apart = got != want
    assert int((apart & ~near).sum()) == 0, case
    step = (got.double() - want.double()).abs()
    assert bool((step[apart] <= want.double().abs()[apart] * 2.0 ** -7 * 1.01).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["qwen decode int8", "starcoder2 extend f32",
                                  "recurrentgemma ring bf16"])
def test_two_parts_merged_equal_the_one_part(cuda_device, case):
    q, k, v, ks, vs, mask = make_inputs(case, cuda_device)
    scale = 1.0 / CASES[case][4] ** 0.5
    parts = []
    for r in range(2):
        sl = slice(r, None, 2)
        o, m, l = seq_attend(q, k[:, sl].contiguous(), v[:, sl].contiguous(),
                             None if ks is None else ks[:, sl].contiguous(),
                             None if vs is None else vs[:, sl].contiguous(),
                             mask[..., sl], scale)
        parts.append(torch.cat([o, m[..., None], l[..., None]], -1))
    two = merge_softmax_parts(torch.stack(parts))
    one = seq_attend(q, k, v, ks, vs, mask, scale)
    whole = merge_softmax_parts(torch.cat([one[0], one[1][..., None],
                                           one[2][..., None]], -1)[None])
    _within(two, whole, "merged")
