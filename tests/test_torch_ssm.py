"""Port parity for ``nn/ssm.py`` ``Mamba2Block`` against the JAX package's,
at a small size in f32 (rtol = atol = 1e-4): ``_segsum``, the chunked SSD
``__call__`` / ``forward_with_state`` at a sequence length equal to the
chunk, a multiple of it and a prime (the chunk shrinks to 1), ``extend``
with ragged valid columns, ``decode_step``, chunked extends against the
monolithic forward, the snapshot and restore of one slot's carry, the f32
carries under bf16 compute, and ``softplus`` against ``jax.nn.softplus``.
The same numpy inputs and weights go to both packages; the SSD parameters
(A_log, D, dt_bias, conv, norm scale) are drawn at random, not left at
their initial values."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy as j_policy
from repro.nn import module as j_mod
from repro.nn import ssm as j_ssm
from repro.nn.context import TRAIN as J_TRAIN
from repro.nn.context import ModelContext as JModelContext
from repro_torch.core import policy as t_policy
from repro_torch.nn import ssm
from repro_torch.nn.context import TRAIN, ModelContext
from repro_torch.serve.weights import params_from_numpy

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
D_MODEL, CHUNK = 32, 8
BLOCK = dict(d_state=16, head_dim=16, expand=2, n_groups=1, conv_width=4,
             chunk=CHUNK)


def _blocks(n_groups=1, cd=None):
    jpol = j_policy.tbn_policy(p=4, min_size=1024, alpha_source="W")
    tpol = t_policy.tbn_policy(p=4, min_size=1024, alpha_source="W")
    kw = dict(BLOCK, n_groups=n_groups)
    jb = j_ssm.Mamba2Block(D_MODEL, JModelContext(
        policy=jpol, mode=J_TRAIN, compute_dtype=jnp.float32), **kw)
    tb = ssm.Mamba2Block(D_MODEL, ModelContext(
        policy=tpol, mode=TRAIN, compute_dtype=cd or torch.float32,
        device="cpu"), **kw)
    return jb, tb


def _params(jb, seed=0):
    """numpy params: the JAX init, with the SSD parameters redrawn."""
    p = jax.tree.map(np.asarray, j_mod.init_params(jb.specs(),
                                                   jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    h, dc, di = jb.n_heads, jb.d_conv, jb.d_inner
    p["A_log"] = rng.uniform(-1.0, 1.0, h).astype(np.float32)
    p["D"] = rng.standard_normal(h).astype(np.float32)
    p["dt_bias"] = rng.uniform(-2.0, 0.5, h).astype(np.float32)
    p["conv_b"] = (0.1 * rng.standard_normal(dc)).astype(np.float32)
    p["norm_scale"] = rng.uniform(0.5, 1.5, di).astype(np.float32)
    return p


def _state(jb, b, seed):
    rng = np.random.default_rng(seed)
    return {"h": (0.3 * rng.standard_normal(
                (b, jb.n_heads, jb.head_dim, jb.d_state))).astype(np.float32),
            "conv": rng.standard_normal(
                (b, jb.conv_width - 1, jb.d_conv)).astype(np.float32)}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return params_from_numpy(tree, "cpu")


def _close(got, want, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=what, **TOL)


def test_segsum_matches_reference():
    x = np.random.default_rng(0).standard_normal((2, 3, 7)).astype(np.float32)
    got = ssm._segsum(torch.from_numpy(x))
    want = np.asarray(j_ssm._segsum(jnp.asarray(x)))
    assert np.array_equal(np.isneginf(got.numpy()), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got.numpy()[fin], want[fin], **TOL)


def test_softplus_matches_jax_past_the_linear_cut():
    x = np.linspace(-30.0, 40.0, 281, dtype=np.float32)
    got = ssm.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n_groups", [1, 2])
@pytest.mark.parametrize("seq", [CHUNK, 3 * CHUNK, 13],
                         ids=["chunk", "multiple", "prime"])
def test_forward_with_state_matches_reference(seq, n_groups):
    jb, tb = _blocks(n_groups)
    p = _params(jb, seed=seq)
    u = np.random.default_rng(seq).standard_normal((2, seq, D_MODEL)).astype(np.float32)
    out_j, st_j = jb.forward_with_state(_j(p), jnp.asarray(u))
    out, st = tb.forward_with_state(_t(p), torch.from_numpy(u))
    _close(out, out_j, "out")
    _close(st["h"], st_j["h"], "h")
    _close(st["conv"], st_j["conv"], "conv")
    _close(tb(_t(p), torch.from_numpy(u)), jb(_j(p), jnp.asarray(u)), "call")


def test_forward_with_state_pads_a_short_conv_tail():
    jb, tb = _blocks()
    p = _params(jb)
    u = np.random.default_rng(1).standard_normal((1, 2, D_MODEL)).astype(np.float32)
    _, st_j = jb.forward_with_state(_j(p), jnp.asarray(u))
    _, st = tb.forward_with_state(_t(p), torch.from_numpy(u))
    assert st["conv"].shape == (1, 3, tb.d_conv) and st["conv"].dtype == torch.float32
    _close(st["conv"], st_j["conv"])
    assert not st["conv"][:, 0].any()


@pytest.mark.parametrize("n_valid", [(6, 3, 0), (1, 6, 4)])
def test_extend_with_ragged_valid_matches_reference(n_valid):
    jb, tb = _blocks()
    p = _params(jb, seed=2)
    b, c = len(n_valid), 6
    rng = np.random.default_rng(sum(n_valid))
    u = rng.standard_normal((b, c, D_MODEL)).astype(np.float32)
    valid = np.arange(c)[None, :] < np.asarray(n_valid)[:, None]
    st0 = _state(jb, b, 4)
    out_j, st_j = jb.extend(_j(p), jnp.asarray(u), _j(st0), jnp.asarray(valid))
    out, st = tb.extend(_t(p), torch.from_numpy(u), _t(st0), torch.from_numpy(valid))
    _close(out, out_j, "out")
    _close(st["h"], st_j["h"], "h")
    _close(st["conv"], st_j["conv"], "conv")
    # a row with no valid column keeps its carry exactly
    for row, n in enumerate(n_valid):
        if n == 0:
            assert torch.equal(st["h"][row], torch.from_numpy(st0["h"][row]))
            assert torch.equal(st["conv"][row], torch.from_numpy(st0["conv"][row]))


def test_decode_step_matches_reference():
    jb, tb = _blocks()
    p = _params(jb, seed=3)
    u = np.random.default_rng(5).standard_normal((3, 1, D_MODEL)).astype(np.float32)
    st0 = _state(jb, 3, 6)
    out_j, st_j = jb.decode_step(_j(p), jnp.asarray(u), _j(st0))
    held = _t(st0)
    out, st = tb.decode_step(_t(p), torch.from_numpy(u), held)
    _close(out, out_j, "out")
    _close(st["h"], st_j["h"], "h")
    _close(st["conv"], st_j["conv"], "conv")
    assert torch.equal(held["h"], torch.from_numpy(st0["h"]))   # not written


@pytest.mark.parametrize("chunks", [(2, 2, 2, 2, 2, 1), (7, 4), (11,)])
def test_chunked_extend_walks_to_the_monolithic_state(chunks):
    """Extending a zero carry chunk by chunk reaches the state the whole-
    sequence forward returns, and the same per-column outputs."""
    jb, tb = _blocks()
    p = _params(jb, seed=4)
    u = np.random.default_rng(9).standard_normal((2, 11, D_MODEL)).astype(np.float32)
    out_full, st_full = tb.forward_with_state(_t(p), torch.from_numpy(u))
    st = tb.init_state(2)
    outs, at = [], 0
    for c in chunks:
        valid = torch.ones((2, c), dtype=torch.bool)
        o, st = tb.extend(_t(p), torch.from_numpy(u[:, at:at + c]), st, valid)
        outs.append(o)
        at += c
    _close(torch.cat(outs, 1), out_full.detach().numpy(), "out")
    _close(st["h"], st_full["h"].detach().numpy(), "h")
    _close(st["conv"], st_full["conv"].detach().numpy(), "conv")


def test_snapshot_and_restore_match_reference():
    jb, tb = _blocks()
    stacked = {k: np.stack([v, v + 1.0]) for k, v in _state(jb, 3, 7).items()}
    snap_j = jb.snapshot_state(_j(stacked), 1, axis=1)
    held = _t(stacked)
    snap = tb.snapshot_state(held, 1, axis=1)
    for k in ("h", "conv"):
        np.testing.assert_array_equal(snap[k].numpy(), np.asarray(snap_j[k]))
    other = _t({k: np.zeros_like(v) for k, v in stacked.items()})
    want = jb.restore_state(_j({k: np.zeros_like(v) for k, v in stacked.items()}),
                            2, snap_j, axis=1)
    got = tb.restore_state(other, 2, snap, axis=1)
    assert got["h"] is other["h"]                 # written in place
    for k in ("h", "conv"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    snap["h"].add_(1.0)                           # a snapshot is its own copy
    assert torch.equal(held["h"], torch.from_numpy(stacked["h"]))


def test_init_state_is_f32_under_bf16_compute():
    _, tb = _blocks(cd=torch.bfloat16)
    st = tb.init_state(3)
    assert st["h"].dtype == st["conv"].dtype == torch.float32
    assert st["h"].shape == (3, tb.n_heads, 16, 16)
    assert st["conv"].shape == (3, 3, tb.d_conv)
    p = _t(_params(_blocks()[0]))
    u = torch.randn(3, 1, D_MODEL, generator=torch.Generator().manual_seed(0))
    out, new = tb.decode_step(p, u, st)
    assert out.dtype == torch.bfloat16
    assert new["h"].dtype == new["conv"].dtype == torch.float32
    _, new = tb.extend(p, u.repeat(1, 3, 1), st, torch.ones((3, 3), dtype=torch.bool))
    assert new["h"].dtype == new["conv"].dtype == torch.float32
