"""The attention's f32 CPU path in the reference's arithmetic, bit for bit
(``core.ordered``: ``ordered_dot``, ``xla_exp``, ``xla_softmax``), against
the JAX package's jitted functions on the CPU:

* ``ordered_dot`` equals XLA's dot for the score and value einsums of
  grouped attention at products of 2 to 64 rows (S * G; at most 16 rows
  XLA keeps 4 FMA accumulators added pairwise, above it one);
* ``xla_exp`` equals ``jnp.exp`` under jit on 3e5 inputs from -90 to 1,
  subnormal results flushed to zero included;
* ``nn.attention._attend_core`` equals the reference's ``_attend_core``
  on the engine's shapes (decode, chunked extend, the encoder's and the
  cross attention's), masked keys included.
Every comparison is exact (``np.array_equal``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn.attention import _attend_core as j_attend_core
from repro_torch.core.ordered import ordered_dot, xla_exp
from repro_torch.nn.attention import _attend_core

torch.set_num_threads(2)


@pytest.mark.parametrize("s,k,g", [(1, 2, 2), (7, 2, 2), (8, 2, 2), (9, 2, 2),
                                   (16, 2, 2), (2, 1, 4), (5, 1, 4), (32, 2, 2)])
def test_ordered_dot_is_xlas_einsum(s, k, g):
    rng = np.random.default_rng(s * 10 + g)
    b, t, h = 2, 24, 16
    q = rng.standard_normal((b, s, k, g, h)).astype(np.float32)
    kk = rng.standard_normal((b, t, k, h)).astype(np.float32)
    p = rng.random((b, k, g, s, t)).astype(np.float32)
    rows = s * g
    want = np.asarray(jax.jit(lambda x, y: jnp.einsum("bskgh,btkh->bkgst", x, y))(q, kk))
    got = ordered_dot(torch.from_numpy(q).permute(0, 2, 3, 1, 4)[:, :, :, :, None],
                      torch.from_numpy(kk).permute(0, 2, 1, 3)[:, :, None, None], rows)
    assert np.array_equal(got.numpy(), want)
    want = np.asarray(jax.jit(lambda x, y: jnp.einsum("bkgst,btkh->bskgh", x, y))(p, kk))
    got = ordered_dot(torch.from_numpy(p).permute(0, 3, 1, 2, 4)[..., None, :],
                      torch.from_numpy(kk).permute(0, 2, 3, 1)[:, None, :, None], rows)
    assert np.array_equal(got.numpy(), want)


def test_xla_exp_is_jits_exp():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-30, 0, 200_000), rng.uniform(-1, 1, 100_000),
                        rng.uniform(-90, -80, 10_000), [-1e30, 0.0]]).astype(np.float32)
    want = np.asarray(jax.jit(jnp.exp)(x))
    got = xla_exp(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, want)
    assert (got[x < -87.4] == 0).any()          # flushed subnormals


@pytest.mark.parametrize("b,s,k,g,t", [(4, 1, 2, 2, 48), (4, 7, 2, 2, 48),
                                       (1, 13, 2, 2, 13), (3, 5, 2, 2, 32),
                                       (1, 16, 2, 2, 16), (2, 1, 1, 4, 40)])
def test_attend_core_is_the_references_bit_for_bit(b, s, k, g, t):
    rng = np.random.default_rng(b + s + t)
    h = 16
    q = rng.standard_normal((b, s, k, g, h)).astype(np.float32)
    kk = rng.standard_normal((b, t, k, h)).astype(np.float32)
    v = rng.standard_normal((b, t, k, h)).astype(np.float32)
    mask = rng.random((b, s, t)) < 0.7
    mask[..., 0] = True
    scale = 1 / np.sqrt(h)
    want = np.asarray(jax.jit(j_attend_core, static_argnums=(4,))(q, kk, v, mask, scale))
    got = _attend_core(*(torch.from_numpy(a) for a in (q, kk, v, mask)), scale)
    assert np.array_equal(got.numpy(), want)
