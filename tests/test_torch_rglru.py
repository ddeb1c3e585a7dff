"""Port parity for ``nn/rglru.py`` ``RGLRUBlock`` against the JAX package's,
at a small size in f32 (rtol = atol = 1e-4): the log-depth ``_lru_scan``
against ``jax.lax.associative_scan``, ``_gates``, ``__call__``,
``extend`` with ragged valid columns (the new conv tail gathered at each
row's count, with no host read), ``decode_step``, the prefill's final
carry (``Block._rec_final_state``), chunked extends against the
monolithic forward, the snapshot and restore of one slot's carry, and
the f32 carries under bf16 compute. The same numpy inputs and weights go
to both packages; ``lam`` and the conv bias are drawn at random."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import policy as j_policy
from repro.models import lm as j_lm
from repro.nn import module as j_mod
from repro.nn import rglru as j_rglru
from repro.nn.context import TRAIN as J_TRAIN
from repro.nn.context import ModelContext as JModelContext
from repro_torch.configs import get_config
from repro_torch.core import policy as t_policy
from repro_torch.models import lm
from repro_torch.nn import rglru
from repro_torch.nn.context import TRAIN, ModelContext
from repro_torch.serve.weights import params_from_numpy

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
D_MODEL = 32


def _ctx(cd=torch.float32):
    jpol = j_policy.tbn_policy(p=4, min_size=512, alpha_source="W")
    tpol = t_policy.tbn_policy(p=4, min_size=512, alpha_source="W")
    return (JModelContext(policy=jpol, mode=J_TRAIN, compute_dtype=jnp.float32),
            ModelContext(policy=tpol, mode=TRAIN, compute_dtype=cd, device="cpu"))


def _blocks(cd=torch.float32):
    jc, tc = _ctx(cd)
    return j_rglru.RGLRUBlock(D_MODEL, jc), rglru.RGLRUBlock(D_MODEL, tc)


def _params(jb, seed=0):
    p = jax.tree.map(np.asarray, j_mod.init_params(jb.specs(),
                                                   jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    p["lam"] = rng.uniform(0.5, 4.0, jb.width).astype(np.float32)
    p["conv_b"] = (0.1 * rng.standard_normal(jb.width)).astype(np.float32)
    return p


def _state(b, seed):
    rng = np.random.default_rng(seed)
    return {"h": rng.standard_normal((b, D_MODEL)).astype(np.float32),
            "conv": rng.standard_normal((b, 3, D_MODEL)).astype(np.float32)}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return params_from_numpy(tree, "cpu")


def _close(got, want, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=what, **TOL)


@pytest.mark.parametrize("seq", [1, 2, 7, 16, 33])
def test_lru_scan_matches_associative_scan(seq):
    rng = np.random.default_rng(seq)
    a = rng.uniform(0.0, 1.0, (2, seq, 5)).astype(np.float32)
    b = rng.standard_normal((2, seq, 5)).astype(np.float32)
    _close(rglru._lru_scan(torch.from_numpy(a), torch.from_numpy(b)),
           j_rglru._lru_scan(jnp.asarray(a), jnp.asarray(b)))


def test_gates_match_reference():
    jb, tb = _blocks()
    p = _params(jb, 1)
    x = np.random.default_rng(2).standard_normal((2, 5, D_MODEL)).astype(np.float32)
    a_j, b_j = jb._gates(_j(p), jnp.asarray(x))
    a, b = tb._gates(_t(p), torch.from_numpy(x))
    _close(a, a_j, "a")
    _close(b, b_j, "b")


@pytest.mark.parametrize("seq", [1, 6, 19])
def test_call_matches_reference(seq):
    jb, tb = _blocks()
    p = _params(jb, seq)
    u = np.random.default_rng(seq).standard_normal((2, seq, D_MODEL)).astype(np.float32)
    _close(tb(_t(p), torch.from_numpy(u)), jb(_j(p), jnp.asarray(u)))


@pytest.mark.parametrize("n_valid", [(6, 2, 0), (1, 5, 6)])
def test_extend_with_ragged_valid_matches_reference(n_valid):
    jb, tb = _blocks()
    p = _params(jb, 3)
    b, c = len(n_valid), 6
    rng = np.random.default_rng(sum(n_valid))
    u = rng.standard_normal((b, c, D_MODEL)).astype(np.float32)
    valid = np.arange(c)[None, :] < np.asarray(n_valid)[:, None]
    st0 = _state(b, 5)
    out_j, st_j = jb.extend(_j(p), jnp.asarray(u), _j(st0), jnp.asarray(valid))
    out, st = tb.extend(_t(p), torch.from_numpy(u), _t(st0), torch.from_numpy(valid))
    _close(out, out_j, "out")
    _close(st["h"], st_j["h"], "h")
    _close(st["conv"], st_j["conv"], "conv")
    for row, n in enumerate(n_valid):
        if n == 0:   # no valid column: the stored carry, exactly
            assert torch.equal(st["h"][row], torch.from_numpy(st0["h"][row]))
            assert torch.equal(st["conv"][row], torch.from_numpy(st0["conv"][row]))


def test_decode_step_matches_reference():
    jb, tb = _blocks()
    p = _params(jb, 4)
    u = np.random.default_rng(6).standard_normal((3, 1, D_MODEL)).astype(np.float32)
    st0 = _state(3, 7)
    out_j, st_j = jb.decode_step(_j(p), jnp.asarray(u), _j(st0))
    held = _t(st0)
    out, st = tb.decode_step(_t(p), torch.from_numpy(u), held)
    _close(out, out_j, "out")
    _close(st["h"], st_j["h"], "h")
    _close(st["conv"], st_j["conv"], "conv")
    assert torch.equal(held["h"], torch.from_numpy(st0["h"]))   # not written


@pytest.mark.parametrize("seq", [2, 3, 9])
def test_rec_final_state_matches_reference(seq):
    """``Block._rec_final_state``: the prefill's last scan state and conv
    tail (zero-padded in front of a prompt shorter than w - 1)."""
    cj = j_get_config("recurrentgemma-2b").reduced()
    ct = get_config("recurrentgemma-2b").reduced()
    jc = JModelContext(policy=cj.tbn, mode=J_TRAIN, compute_dtype=jnp.float32)
    tc = ModelContext(policy=ct.tbn, mode=TRAIN, compute_dtype=torch.float32,
                      device="cpu")
    jblk = j_lm.Block(cj, jc, "rec", False, name="tail0")
    tblk = lm.Block(ct, tc, name="tail0", kind="rec")
    p = jax.tree.map(np.asarray, j_mod.init_params(jblk.specs(),
                                                   jax.random.PRNGKey(seq)))
    h = np.random.default_rng(seq).standard_normal((2, seq, ct.d_model)).astype(np.float32)
    want = jblk._rec_final_state(_j(p)["mixer"], jnp.asarray(h))
    got = tblk._rec_final_state(_t(p)["mixer"], torch.from_numpy(h))
    _close(got["h"], want["h"], "h")
    _close(got["conv"], want["conv"], "conv")
    x_j, c_j = jblk.prefill(_j(p), jnp.asarray(h))
    x, c = tblk.prefill(_t(p), torch.from_numpy(h))
    _close(x, x_j, "prefill x")
    _close(c["h"], c_j["h"], "prefill h")


def test_chunked_extend_walks_to_the_monolithic_output():
    jb, tb = _blocks()
    p = _t(_params(jb, 8))
    u = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 10, D_MODEL)).astype(np.float32))
    full = tb(p, u)
    st, outs = tb.init_state(2), []
    for a, c in ((0, 3), (3, 3), (6, 4)):
        o, st = tb.extend(p, u[:, a:a + c], st, torch.ones((2, c), dtype=torch.bool))
        outs.append(o)
    _close(torch.cat(outs, 1), full.detach().numpy())
    o, _ = tb.decode_step(p, u[:, :1], st)
    assert torch.isfinite(o).all()


def test_snapshot_and_restore_match_reference():
    jb, tb = _blocks()
    stacked = {k: np.stack([v, 2 * v]) for k, v in _state(3, 9).items()}
    snap_j = jb.snapshot_state(_j(stacked), 2, axis=1)
    snap = tb.snapshot_state(_t(stacked), 2, axis=1)
    for k in ("h", "conv"):
        np.testing.assert_array_equal(snap[k].numpy(), np.asarray(snap_j[k]))
    zeros = {k: np.zeros_like(v) for k, v in stacked.items()}
    want = jb.restore_state(_j(zeros), 0, snap_j, axis=1)
    held = _t(zeros)
    got = tb.restore_state(held, 0, snap, axis=1)
    assert got["conv"] is held["conv"]
    for k in ("h", "conv"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_carries_stay_f32_under_bf16_compute():
    jb, tb = _blocks(torch.bfloat16)
    p = _t(_params(jb))
    st = tb.init_state(2)
    assert st["h"].dtype == st["conv"].dtype == torch.float32
    u = torch.randn(2, 3, D_MODEL, generator=torch.Generator().manual_seed(1))
    y, new = tb.extend(p, u, st, torch.ones((2, 3), dtype=torch.bool))
    assert y.dtype == torch.bfloat16
    assert new["h"].dtype == new["conv"].dtype == torch.float32
    y, new = tb.decode_step(p, u[:, :1], new)
    assert new["h"].dtype == new["conv"].dtype == torch.float32
