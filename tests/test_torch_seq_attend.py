"""Kernel B9's plain version (``kernels/seq_attend.py``), the f64 partial
softmax of a "seq" attention layer, against the JAX package's attention
on the CPU.

The same numpy inputs (a seed) go to ``repro.nn.attention._attend_core``
(f32; int8 codes dequantized, which the scale-factored order equals up to
rounding) and to B9's plain version: as one part (``out_dtype``: divided
and rounded once, as one card attends) and as two parts of interleaved
keys (position p on part p mod 2, as a (1, 2) mesh holds them) merged by
``distributed.sharding.merge_softmax_parts``. Both meet the JAX output at
f32 1e-4 x max|out| for bf16 / f32 K/V and int8 codes with scales, under
a causal mask with per-slot lengths, a sliding window, a part with no
valid key for a row and a row with none anywhere (0, finite), at G = 1
and G > 1. The fake implementation gives the outputs' shapes and types
on ``meta``, and ``roofline.analysis.CostCounter`` counts a call as B9
with ``kernel_terms``' work.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn.attention import _attend_core as j_attend_core
from repro_torch.distributed.sharding import SeqBlock, merge_partials, merge_softmax_parts
from repro_torch.kernels.seq_attend import NEG_INF, seq_attend, seq_attend_plain
from repro_torch.roofline.analysis import CostCounter, kernel_terms

B, S, K, HD, T = 2, 3, 2, 16, 12
RTOL = 1e-4


def _inputs(kv, g, case, seed=0):
    """numpy q (B, S, K, G, hd) f32, k / v (B, T, K, hd) (f32 values, or
    int8 codes with (B, T, K) f32 scales), and the (B, S, T) mask."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, K, g, HD)).astype(np.float32)
    if kv == "int8":
        k = rng.integers(-127, 128, (B, T, K, HD)).astype(np.int8)
        v = rng.integers(-127, 128, (B, T, K, HD)).astype(np.int8)
        ks = (rng.random((B, T, K)) * 0.02 + 1e-3).astype(np.float32)
        vs = (rng.random((B, T, K)) * 0.02 + 1e-3).astype(np.float32)
    else:
        k = rng.standard_normal((B, T, K, HD)).astype(np.float32)
        v = rng.standard_normal((B, T, K, HD)).astype(np.float32)
        if kv == "bf16":       # values a bf16 cache holds exactly
            k = torch.from_numpy(k).bfloat16().float().numpy()
            v = torch.from_numpy(v).bfloat16().float().numpy()
        ks = vs = None
    q_pos = np.array([[7, 8, 9], [9, 10, 11]])[:, :S]
    k_pos = np.arange(T)
    mask = q_pos[:, :, None] >= k_pos[None, None, :]
    if case == "window":
        mask &= q_pos[:, :, None] - k_pos[None, None, :] < 4
    elif case == "empty part":       # row 0's odd keys all masked
        mask[:, 0, 1::2] = False
    elif case == "empty row":
        mask[1, 2] = False
    return q, k, v, ks, vs, mask


def _jax_out(q, k, v, ks, vs, mask):
    """The JAX package's attention (f32) of the same values."""
    if ks is not None:
        k = k.astype(np.float32) * ks[..., None]
        v = v.astype(np.float32) * vs[..., None]
    out = j_attend_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(mask), 1.0 / math.sqrt(HD))
    return np.asarray(out)


def _torch(q, k, v, ks, vs, mask, kv):
    tq = torch.from_numpy(q)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    if kv == "bf16":
        tk, tv = tk.bfloat16(), tv.bfloat16()
    tks = None if ks is None else torch.from_numpy(ks)
    tvs = None if vs is None else torch.from_numpy(vs)
    return tq, tk, tv, tks, tvs, torch.from_numpy(mask)


def _close(got, want, live):
    atol = RTOL * float(np.abs(want).max())
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=atol)


@pytest.mark.parametrize("case", ["causal", "window", "empty part", "empty row"])
@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
def test_one_part_and_two_parts_meet_the_jax_attention(kv, g, case):
    q, k, v, ks, vs, mask = _inputs(kv, g, case)
    want = _jax_out(q, k, v, ks, vs, mask)
    args = _torch(q, k, v, ks, vs, mask, kv)
    scale = 1.0 / math.sqrt(HD)
    live = mask.any(-1)                                   # (B, S)
    # one part, rounded once in the epilogue = the merge of the one part
    one, m, l = seq_attend(*args, scale, torch.float32)
    assert one.dtype == torch.float32 and m.dtype == l.dtype == torch.float64
    o, m1, l1 = seq_attend(*args, scale)
    assert o.dtype == torch.float64
    assert torch.equal(one, merge_partials(o, m1, l1, SeqBlock(None, (), 1, 0)).float())
    _close(one.numpy(), want, live)
    assert (one.numpy()[~live] == 0).all()
    assert (m1.numpy()[~live] == NEG_INF).all() and (l1.numpy()[~live] == 0).all()
    # two parts of interleaved keys, merged in part order
    tq, tk, tv, tks, tvs, tm = args
    parts = []
    for r in range(2):
        sl = slice(r, None, 2)
        o, m, l = seq_attend_plain(tq, tk[:, sl], tv[:, sl],
                                   None if tks is None else tks[:, sl],
                                   None if tvs is None else tvs[:, sl],
                                   tm[..., sl], scale)
        parts.append(torch.cat([o, m[..., None], l[..., None]], -1))
    two = merge_softmax_parts(torch.stack(parts))
    assert torch.isfinite(two).all()
    _close(two.float().numpy(), want, live)
    assert (two.numpy()[~live] == 0).all()
    if case == "empty part":      # row 0 has no valid key in part 1
        assert (parts[1][:, 0, ..., -2] == NEG_INF).all()
        assert (parts[1][:, 0, ..., -1] == 0).all()


@pytest.mark.parametrize("out_dtype", [None, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_fake_implementation_gives_the_outputs_shapes(kv, out_dtype):
    q = torch.empty((4, 1, 8, 5, 128), dtype=torch.bfloat16, device="meta")
    dt = torch.int8 if kv == "int8" else torch.bfloat16
    k = torch.empty((4, 256, 8, 128), dtype=dt, device="meta")
    scales = (torch.empty((4, 256, 8), device="meta"),) * 2 if kv == "int8" else (None, None)
    mask = torch.empty((4, 1, 256), dtype=torch.bool, device="meta")
    o, m, l = seq_attend(q, k, k, *scales, mask, 0.1, out_dtype)
    assert o.shape == q.shape and o.dtype == (out_dtype or torch.float64)
    assert m.shape == l.shape == (4, 1, 8, 5)
    assert m.dtype == l.dtype == torch.float64 and o.device.type == "meta"


def test_cost_counter_counts_one_call_as_b9():
    b, s, kh, g, hd, t = 4, 1, 8, 5, 128, 256
    q = torch.empty((b, s, kh, g, hd), dtype=torch.bfloat16, device="meta")
    k = torch.empty((b, t, kh, hd), dtype=torch.int8, device="meta")
    ks = torch.empty((b, t, kh), device="meta")
    mask = torch.empty((b, s, t), dtype=torch.bool, device="meta")
    with CostCounter() as cc:
        seq_attend(q, k, k, ks, ks, mask, 0.1, torch.bfloat16)
    assert cc.kernels == {"B9": 1}
    ops, nbytes = cc.kernel_work["B9"]
    assert ops == 4.0 * hd * kh * g * b * s * t
    kv_bytes = b * t * kh * (2 * hd + 2 * 4)
    out = b * s * kh * g * (hd * 2 + 16)
    assert nbytes == b * s * kh * g * hd * 2 + kv_bytes + b * s * t + out
    work = kernel_terms("B9", q.shape, k.shape, q.dtype, kv_dtype=k.dtype,
                        out_dtype=torch.bfloat16)
    assert (work.ops, work.bytes, work.peak) == (ops, nbytes, "f64")


def test_kernel_terms_count_what_the_mask_lets_through():
    """With the mask, the pairs it lets through and the keys any of a
    slot's rows reads (the kernel skips the others)."""
    q_shape, k_shape = (2, 2, 1, 3, 16), (2, 8, 1, 16)
    mask = torch.zeros((2, 2, 8), dtype=torch.bool)
    mask[0, 0, :3] = True
    mask[0, 1, :4] = True
    mask[1, :, 5] = True
    work = kernel_terms("B9", q_shape, k_shape, torch.float32, mask=mask)
    assert work.ops == 4.0 * 16 * 1 * 3 * (3 + 4 + 2)
    keys = 4 + 1
    assert work.bytes == (2 * 2 * 3 * 16 * 4 + keys * 2 * 16 * 4 + 2 * 2 * 8
                          + 2 * 2 * 3 * (16 * 8 + 16))


@pytest.mark.parametrize("bad", ["codes without scales", "scales without codes",
                                 "mask shape", "q rank"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    q = torch.zeros((1, 2, 1, 2, 16))
    k = torch.zeros((1, 4, 1, 16))
    mask = torch.ones((1, 2, 4), dtype=torch.bool)
    ks = torch.ones((1, 4, 1))
    args = {"codes without scales": (q, k.to(torch.int8), k.to(torch.int8), None, None, mask),
            "scales without codes": (q, k, k, ks, ks, mask),
            "mask shape": (q, k, k, None, None, mask[..., :3]),
            "q rank": (q[0], k, k, None, None, mask)}[bad]
    with pytest.raises((ValueError, TypeError)):
        seq_attend(*args, 0.25)
