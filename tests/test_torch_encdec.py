"""Port parity for the encoder-decoder family at the model level, against
the JAX package in f32 (rtol = atol = 1e-4): ``Attention`` with an encoder
memory and a key mask (``kv_src`` / ``kv_valid``), ``cross_kv`` and the
paged ``cross_attend``; ``EncDecModel``'s ``encode``, ``decode``,
``train_forward`` loss and every TRAIN gradient; the dense ``prefill`` +
``decode_step`` anchor; ``encode_serve`` (its valid rows equal an unpadded
``encode``); ``write_cross``'s pool rows; the paged ``extend`` /
``decode_step`` under every compute path; the export (every tile
bit-exact, the cross-attention ones among them, and the LM head of an
unaligned vocabulary, as seamless's 256206 = 2 mod 4: no aligned tiling,
so it ships as BWNN sign bits, rebuilt densely at every call, as in the
reference), the ledger, the streamed ``build_serving``, and shipped bytes
below the masters'."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build_model as j_build_model
from repro.configs import get_config as j_get_config
from repro.nn import module as j_mod
from repro.nn.attention import Attention as JAttention
from repro.nn.attention import scatter_pages as j_scatter_pages
from repro.nn.context import SERVE as J_SERVE
from repro.nn.context import TRAIN as J_TRAIN
from repro.nn.context import ModelContext as JModelContext
from repro.serve.weights import export_serving_params as j_export
from repro_torch.configs import build_model, get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.nn import module as mod
from repro_torch.nn.attention import Attention, scatter_pages
from repro_torch.nn.context import SERVE, TRAIN, ModelContext
from repro_torch.serve.weights import (
    export_serving_params,
    params_from_numpy,
    spec_bytes,
)

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "seamless-m4t-large-v2"
PATHS = ("float", "xnor", "int8")
# reduced seamless, and the same with an unaligned vocabulary (514 = 2 mod
# p = 4, as the full config's 256206): its LM head ships as sign bits
VOCABS = (None, 514)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return params_from_numpy(_np(tree), "cpu")


def _leaves(tree):
    return {"/".join(p): v for p, v in mod.walk(tree)}


def _cfgs(vocab=None):
    cj, ct = j_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    if vocab:
        cj = dataclasses.replace(cj, vocab=vocab)
        ct = dataclasses.replace(ct, vocab=vocab)
    return cj, ct


@functools.lru_cache(maxsize=None)
def _models(vocab=None):
    """JAX (cfg, TRAIN model, masters, SERVE params) and the port's (cfg,
    TRAIN model), masters from PRNGKey(2)."""
    cj, ct = _cfgs(vocab)
    tm_j = j_build_model(cj, JModelContext(policy=cj.tbn, mode=J_TRAIN,
                                           compute_dtype=jnp.float32))
    sm_j = j_build_model(cj, JModelContext(policy=cj.tbn, mode=J_SERVE,
                                           compute_dtype=jnp.float32,
                                           use_pallas=False))
    masters = j_mod.init_params(tm_j.specs(), jax.random.PRNGKey(2))
    sp_j = j_export(tm_j.specs(), sm_j.specs(), masters, cj.tbn)
    tm = build_model(ct, ModelContext(policy=ct.tbn, mode=TRAIN,
                                      compute_dtype=torch.float32, device="cpu"))
    return (cj, tm_j, masters, sp_j), (ct, tm)


def _serve_models(path="float", vocab=None):
    cj, ct = _cfgs(vocab)
    sm_j = j_build_model(cj, JModelContext(policy=cj.tbn, mode=J_SERVE,
                                           compute_dtype=jnp.float32,
                                           use_pallas=False, compute_path=path))
    sm = build_model(ct, ModelContext(policy=ct.tbn, mode=SERVE,
                                      compute_dtype=torch.float32, device="cpu",
                                      compute_path=path))
    return sm_j, sm


def _frames(b, s, d, seed=5):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


# ----------------------------------------------------------------------
# Attention: memory, key mask, cross helpers
# ----------------------------------------------------------------------
ATTN_CASES = {
    # name: (Attention kwargs, kv_src?, kv_valid?, q_chunk)
    "encoder-masked": (dict(causal=False, rope=False), False, True, 1024),
    "encoder-rope": (dict(causal=False), False, True, 1024),
    "cross-masked": (dict(causal=False, cross=True, rope=False), True, True, 1024),
    "cross-qknorm": (dict(causal=False, cross=True, qk_norm=True), True, False, 1024),
    "cross-chunked": (dict(causal=False, cross=True, rope=False), True, True, 2),
    "encoder-chunked": (dict(causal=False, rope=False), False, True, 2),
}


def _attn_pair(kw, q_chunk, seed=0):
    d, h, kv, hd = 32, 4, 2, 8
    ja = JAttention(d, h, kv, JModelContext(mode=J_TRAIN, compute_dtype=jnp.float32),
                    head_dim=hd, q_chunk=q_chunk, **kw)
    ta = Attention(d, h, kv, ModelContext(mode=TRAIN, compute_dtype=torch.float32,
                                          device="cpu"),
                   head_dim=hd, q_chunk=q_chunk, **kw)
    pj = j_mod.init_params(ja.specs(), jax.random.PRNGKey(seed))
    return ja, ta, pj, _t(pj)


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_memory_and_key_mask_match_reference(case):
    kw, cross, masked, q_chunk = ATTN_CASES[case]
    ja, ta, pj, pt = _attn_pair(kw, q_chunk)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 32)).astype(np.float32)
    mem = rng.standard_normal((2, 12, 32)).astype(np.float32) if cross else None
    t = 12 if cross else 8
    valid = (np.arange(t)[None, :] < np.array([[t - 3], [t]])) if masked else None
    jkw, tkw = {}, {}
    if cross:
        jkw["kv_src"], tkw["kv_src"] = jnp.asarray(mem), torch.from_numpy(mem)
    if masked:
        jkw["kv_valid"], tkw["kv_valid"] = jnp.asarray(valid), torch.from_numpy(valid)
    want = np.asarray(ja(pj, jnp.asarray(x), **jkw))
    got = ta(pt, torch.from_numpy(x), **tkw)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_kv_and_paged_cross_attend_match_reference(qk_norm):
    kw = dict(causal=False, cross=True, rope=False, qk_norm=qk_norm)
    ja, ta, pj, pt = _attn_pair(kw, 1024, seed=3)
    rng = np.random.default_rng(2)
    mem = rng.standard_normal((2, 11, 32)).astype(np.float32)
    kj, vj = ja.cross_kv(pj, jnp.asarray(mem))
    kt, vt = ta.cross_kv(pt, torch.from_numpy(mem))
    np.testing.assert_allclose(kt.detach().numpy(), np.asarray(kj), **TOL)
    np.testing.assert_allclose(vt.detach().numpy(), np.asarray(vj), **TOL)
    # write both slots' rows through a cross table into pools of 8 pages of
    # 4 rows (the port's has its scratch page last), then attend
    n_pages, pt_, npp = 8, 4, 3
    table = np.array([[5, 0, 2], [7, 1, 3]], np.int32)
    pos = np.broadcast_to(np.arange(11), (2, 11))
    enc_lens = np.array([11, 6], np.int32)
    valid = pos < enc_lens[:, None]
    zj = jnp.zeros((n_pages, pt_, 2, 8), jnp.float32)
    pkj = j_scatter_pages(zj, jnp.asarray(table), jnp.asarray(pos), kj, jnp.asarray(valid))
    pvj = j_scatter_pages(zj, jnp.asarray(table), jnp.asarray(pos), vj, jnp.asarray(valid))
    pkt = torch.zeros((n_pages + 1, pt_, 2, 8))
    pvt = torch.zeros((n_pages + 1, pt_, 2, 8))
    tt, post, vt_ = (torch.from_numpy(table), torch.from_numpy(np.array(pos)),
                     torch.from_numpy(valid))
    scatter_pages(pkt, tt, post, kt.detach(), vt_)
    scatter_pages(pvt, tt, post, vt.detach(), vt_)
    np.testing.assert_allclose(pkt[:n_pages].numpy(), np.asarray(pkj), **TOL)
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    want = ja.cross_attend(pj, jnp.asarray(x), pkj, pvj, jnp.asarray(enc_lens),
                           page_table=jnp.asarray(table))
    got = ta.cross_attend(pt, torch.from_numpy(x), pkt, pvt,
                          torch.from_numpy(enc_lens), page_table=tt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    # the dense (unpaged) form attends the memory rows directly
    dense = ta.cross_attend(pt, torch.from_numpy(x), kt, vt,
                            torch.from_numpy(enc_lens))
    np.testing.assert_allclose(dense.detach().numpy(), got.detach().numpy(), **TOL)


# ----------------------------------------------------------------------
# EncDecModel: specs, training
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("reduced", [False, True])
def test_param_specs_match_reference(mode, reduced):
    cj, ct = j_get_config(ARCH), get_config(ARCH)
    if reduced:
        cj, ct = cj.reduced(), ct.reduced()
    jm = j_build_model(cj, JModelContext(policy=cj.tbn,
                                         mode=J_TRAIN if mode == "train" else J_SERVE))
    tm = build_model(ct, ModelContext(policy=ct.tbn,
                                      mode=TRAIN if mode == "train" else SERVE,
                                      device="cpu"))
    js = {"/".join(p): s for p, s in j_mod._walk(jm.specs())}
    ts = {"/".join(p): s for p, s in mod.walk(tm.specs())}
    assert ts.keys() == js.keys()
    for k, s in ts.items():
        assert tuple(s.shape) == tuple(js[k].shape), k
        assert str(s.dtype).removeprefix("torch.") == np.dtype(js[k].dtype).name, k


def test_encode_and_decode_match_reference():
    (cj, tm_j, masters, _), (ct, tm) = _models()
    frames = _frames(2, 12, ct.d_model)
    toks = np.random.default_rng(3).integers(0, ct.vocab, (2, 6)).astype(np.int32)
    params = _t(masters)
    with torch.no_grad():
        mem = tm.encode(params, torch.from_numpy(frames))
        h = tm.decode(params, torch.from_numpy(toks).long(), mem)
    mem_j = tm_j.encode(masters, jnp.asarray(frames))
    h_j = tm_j.decode(masters, jnp.asarray(toks), mem_j)
    np.testing.assert_allclose(mem.numpy(), np.asarray(mem_j), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), **TOL)


def test_train_forward_loss_and_grads_match_reference():
    (cj, tm_j, masters, _), (ct, tm) = _models()
    batch = {"frames": _frames(2, 16, ct.d_model) * 0.1,
             "tokens": np.random.default_rng(3).integers(
                 0, ct.vocab, (2, 4)).astype(np.int32)}
    (loss_j, met_j), g_j = jax.value_and_grad(tm_j.train_forward, has_aux=True)(
        masters, {k: jnp.asarray(v) for k, v in batch.items()})
    params = _t(masters)
    paths, leaves = zip(*mod.walk(params))
    for v in leaves:
        v.requires_grad_()
    loss, met = tm.train_forward(params, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), **TOL)
    np.testing.assert_allclose(float(met["ce"].detach()), float(met_j["ce"]), **TOL)
    g_j = _np(g_j)
    assert len(grads) == len(_leaves(g_j))
    for path, g in zip(paths, grads):
        want = _leaves(g_j)["/".join(path)]
        np.testing.assert_allclose(
            g.numpy(), want, rtol=1e-4, atol=1e-4 * max(1.0, float(np.abs(want).max())),
            err_msg="/".join(path))


def test_remat_none_gives_the_same_loss():
    (_, _, masters, _), (ct, _) = _models()
    batch = {"frames": torch.from_numpy(_frames(2, 8, ct.d_model)),
             "tokens": torch.from_numpy(np.random.default_rng(4).integers(
                 0, ct.vocab, (2, 4)))}
    losses = []
    for remat in ("full", "none"):
        cfg = dataclasses.replace(ct, remat=remat)
        m = build_model(cfg, ModelContext(policy=cfg.tbn, mode=TRAIN,
                                          compute_dtype=torch.float32, device="cpu"))
        losses.append(float(m.train_forward(_t(masters), batch)[0]))
    assert losses[0] == losses[1]


# ----------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------
@pytest.mark.parametrize("vocab", VOCABS)
def test_export_matches_reference(vocab):
    """Every tile bit-exact (the cross-attention ones and frame_proj among
    them), alpha within 1e-6, the rest equal (the sign bits of an unaligned
    head among them)."""
    (cj, tm_j, masters_j, sp_j), (ct, tm) = _models(vocab)
    sm = build_model(ct, ModelContext(policy=ct.tbn, mode=SERVE,
                                      compute_dtype=torch.float32, device="cpu"))
    sp = _leaves(export_serving_params(tm.specs(), sm.specs(), _t(masters_j), ct.tbn))
    want = _leaves(_np(sp_j))
    assert set(sp) == set(want) == set(_leaves(sm.specs()))
    tiles = []
    for path, w in want.items():
        got = sp[path].numpy()
        assert got.shape == w.shape, path
        if path.endswith("tile"):
            np.testing.assert_array_equal(got, w, err_msg=path)
            tiles.append(path)
        elif path.endswith("alpha"):
            np.testing.assert_allclose(got, w, rtol=0, atol=1e-6, err_msg=path)
        else:
            np.testing.assert_array_equal(got, w, err_msg=path)
    assert {"dec/cross_attn/wk/tile", "dec/cross_attn/wq/tile",
            "dec/cross_attn/wv/tile", "dec/cross_attn/wo/tile",
            "frame_proj/tile"} <= set(tiles)
    # the unaligned vocabulary's head: (vocab, d / 32) sign words + one alpha
    head = "head/wbits" if vocab else "head/tile"
    assert head in sp and (head in tiles) != bool(vocab)


@pytest.mark.parametrize("reduced", [False, True])
def test_ledger_and_shipped_bytes_below_masters(reduced):
    cj, ct = j_get_config(ARCH), get_config(ARCH)
    if reduced:
        cj, ct = cj.reduced(), ct.reduced()
    jctx = JModelContext(policy=cj.tbn, mode=J_SERVE)
    tctx = ModelContext(policy=ct.tbn, mode=SERVE, device="cpu")
    j_build_model(cj, jctx)
    sm = build_model(ct, tctx)
    jr, tr = jctx.ledger.report(), tctx.ledger.report()
    assert tr.rows() == jr.rows()
    assert tr.summary(ct.name) == jr.summary(cj.name)
    tm = build_model(ct, ModelContext(policy=ct.tbn, mode=TRAIN, device="cpu"))
    assert spec_bytes(sm.specs()) < spec_bytes(tm.specs())


def test_streamed_build_serving_equals_whole_tree_export():
    cfg = get_config(ARCH).reduced()
    sm, sp, master_b = serve_cli.build_serving(cfg, device="cpu", seed=3,
                                               compute_dtype=torch.float32)
    tm = build_model(cfg, ModelContext(policy=cfg.tbn, mode=TRAIN,
                                       compute_dtype=torch.float32, device="cpu"))
    want = _leaves(export_serving_params(tm.specs(), sm.specs(), tm.init(3), cfg.tbn))
    got = _leaves(sp)
    assert got.keys() == want.keys()
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
    assert master_b == sum(v.numel() * 4 for _, v in mod.walk(tm.init(3)))


@pytest.mark.parametrize("vocab", VOCABS)
def test_prefill_and_dense_decode_match_reference(vocab):
    (cj, _, _, sp_j), (ct, _) = _models(vocab)
    sm_j, sm = _serve_models("float", vocab)
    sp = _t(sp_j)
    frames = _frames(2, 9, ct.d_model)
    toks = np.random.default_rng(6).integers(0, ct.vocab, (2, 5)).astype(np.int32)
    lj, cj_, nj = sm_j.prefill(sp_j, {"frames": jnp.asarray(frames),
                                      "tokens": jnp.asarray(toks)}, 16)
    with torch.no_grad():
        lt, ct_, nt = sm.prefill(sp, {"frames": torch.from_numpy(frames),
                                      "tokens": torch.from_numpy(toks)}, 16)
        for step in range(3):
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
            assert set(ct_) == set(cj_) == {"k", "v", "ck", "cv"}
            for n in ct_:
                np.testing.assert_allclose(ct_[n].numpy(), np.asarray(cj_[n]), **TOL)
            assert np.array_equal(nt.numpy(), np.asarray(nj))
            nxt = np.asarray(jnp.argmax(lj, -1))[:, None].astype(np.int32)
            lj, cj_, nj = sm_j.decode_step(sp_j, jnp.asarray(nxt), cj_, nj)
            lt, ct_, nt = sm.decode_step(sp, torch.from_numpy(nxt), ct_, nt)


def test_encode_serve_valid_rows_equal_unpadded_encode():
    (cj, _, _, sp_j), (ct, _) = _models()
    sm_j, sm = _serve_models()
    sp = _t(sp_j)
    frames = _frames(1, 11, ct.d_model)
    padded = np.zeros((1, 16, ct.d_model), np.float32)
    padded[:, :11] = frames
    valid = np.arange(16)[None, :] < 11
    with torch.no_grad():
        mem = sm.encode_serve(sp, torch.from_numpy(padded), torch.from_numpy(valid))
        ref = sm.encode(sp, torch.from_numpy(frames))
    np.testing.assert_allclose(mem[:, :11].numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)
    assert torch.isfinite(mem).all()
    want = sm_j.encode_serve(sp_j, jnp.asarray(padded), jnp.asarray(valid))
    np.testing.assert_allclose(mem[:, :11].numpy(), np.asarray(want)[:, :11], **TOL)
    # every frame masked (the warmup's encode): finite rows
    with torch.no_grad():
        none = sm.encode_serve(sp, torch.zeros(1, 16, ct.d_model),
                               torch.zeros(1, 16, dtype=torch.bool))
    assert torch.isfinite(none).all()


def _pools(sm, sm_j, n_self, n_cross, pt):
    cj_ = sm_j.init_caches(2, 32, jnp.float32, page_tokens=pt, n_pages=n_self,
                           cross_pages=n_cross)
    ct_ = sm.init_caches(2, 32, torch.float32, page_tokens=pt, n_pages=n_self,
                         cross_pages=n_cross)
    return cj_, ct_


def _assert_pools(ct_, cj_):
    """The port's pools (a scratch page last) against the reference's."""
    for fam in ("self", "cross"):
        for n in ("k", "v"):
            got, want = ct_[fam][n], np.asarray(cj_[fam][n])
            assert got.shape[1] == want.shape[1] + 1
            np.testing.assert_allclose(got[:, :-1].numpy(), want, err_msg=f"{fam}/{n}",
                                       **TOL)


def test_write_cross_pool_rows_match_reference():
    (cj, _, _, sp_j), (ct, _) = _models()
    sm_j, sm = _serve_models()
    sp = _t(sp_j)
    pt, enc_tokens = 4, 12
    cj_, ct_ = _pools(sm, sm_j, 16, 9, pt)
    xrow = np.array([[6, 2, 4]], np.int32)
    frames = np.zeros((1, enc_tokens, ct.d_model), np.float32)
    frames[:, :7] = _frames(1, 7, ct.d_model)
    valid = np.arange(enc_tokens)[None, :] < 7
    pos = np.arange(enc_tokens)[None, :]
    mem_j = sm_j.encode_serve(sp_j, jnp.asarray(frames), jnp.asarray(valid))
    cj_ = sm_j.write_cross(sp_j, mem_j, cj_, jnp.asarray(xrow), jnp.asarray(pos),
                           jnp.asarray(valid))
    with torch.no_grad():
        mem = sm.encode_serve(sp, torch.from_numpy(frames), torch.from_numpy(valid))
        out = sm.write_cross(sp, mem, ct_, torch.from_numpy(xrow),
                             torch.from_numpy(pos), torch.from_numpy(valid))
    assert out is ct_
    _assert_pools(ct_, cj_)
    # pages 6 and 2 hold the 7 rows; every other page is untouched
    used = ct_["cross"]["k"][:, :-1].abs().sum(dim=(0, 2, 3, 4)) > 0
    assert used.nonzero().flatten().tolist() == [2, 6]


@pytest.mark.parametrize("path", PATHS)
def test_paged_extend_and_decode_match_reference(path):
    """Two slots with sources of 7 and 12 frames: encode + write_cross each
    through its cross row, then an extend of ragged prompts (5 and 3 of 5
    columns) and two decode steps, logits and both pools held to the
    reference's after every call."""
    (cj, _, _, sp_j), (ct, _) = _models()
    sm_j, sm = _serve_models(path)
    sp = _t(sp_j)
    pt, enc_tokens = 4, 12
    cj_, ct_ = _pools(sm, sm_j, 16, 9, pt)
    xptab = np.array([[6, 2, 4], [0, 1, 3]], np.int32)
    enc_lens = np.array([7, 12], np.int32)
    src = _frames(2, enc_tokens, ct.d_model, seed=9)
    pos = np.arange(enc_tokens)[None, :]
    with torch.no_grad():
        for b in range(2):
            frames = np.zeros((1, enc_tokens, ct.d_model), np.float32)
            frames[0, :enc_lens[b]] = src[b, :enc_lens[b]]
            valid = pos < enc_lens[b]
            mem_j = sm_j.encode_serve(sp_j, jnp.asarray(frames), jnp.asarray(valid))
            cj_ = sm_j.write_cross(sp_j, mem_j, cj_, jnp.asarray(xptab[b:b + 1]),
                                   jnp.asarray(pos), jnp.asarray(valid))
            mem = sm.encode_serve(sp, torch.from_numpy(frames), torch.from_numpy(valid))
            sm.write_cross(sp, mem, ct_, torch.from_numpy(xptab[b:b + 1]),
                           torch.from_numpy(pos), torch.from_numpy(valid))
        _assert_pools(ct_, cj_)
        ptab = np.array([[3, 5, 7, 9], [4, 6, 8, 10]], np.int32)
        toks = np.random.default_rng(8).integers(0, ct.vocab, (2, 5)).astype(np.int32)
        n_new = np.array([5, 3], np.int32)
        lengths = np.zeros(2, np.int32)
        xk = dict(cross_page_table=xptab, enc_lens=enc_lens)
        lj, cj_, nj = sm_j.extend(sp_j, jnp.asarray(toks), cj_, jnp.asarray(lengths),
                                  jnp.asarray(n_new), page_table=jnp.asarray(ptab),
                                  **{k: jnp.asarray(v) for k, v in xk.items()})
        lt, out, nt = sm.extend(sp, torch.from_numpy(toks), ct_,
                                torch.from_numpy(lengths), torch.from_numpy(n_new),
                                page_table=torch.from_numpy(ptab),
                                **{k: torch.from_numpy(v) for k, v in xk.items()})
        assert out is ct_
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        _assert_pools(ct_, cj_)
        active = np.array([True, True])
        for step in range(2):
            if step:
                active = np.array([True, False])     # slot 1 drops its write
            nxt = np.asarray(jnp.argmax(lj, -1))[:, None].astype(np.int32)
            lj, cj_, nj2 = sm_j.decode_step(
                sp_j, jnp.asarray(nxt), cj_, nj, page_table=jnp.asarray(ptab),
                active=jnp.asarray(active),
                **{k: jnp.asarray(v) for k, v in xk.items()})
            lt, _, nt2 = sm.decode_step(
                sp, torch.from_numpy(nxt), ct_, nt, page_table=torch.from_numpy(ptab),
                active=torch.from_numpy(active),
                **{k: torch.from_numpy(v) for k, v in xk.items()})
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
            _assert_pools(ct_, cj_)
            nj = jnp.where(jnp.asarray(active), nj2, nj)
            nt = torch.where(torch.from_numpy(active), nt2, nt)


def test_frames_batch_matches_reference_shapes():
    """The train CLI's encoder-decoder batch: the reference's keys, shapes
    and dtypes; frames 0.1 * N(0, 1); decoder tokens ``lm_batch``'s at
    max(2, seq // dec_ratio); a pure function of (seed, step)."""
    from repro.data.synthetic import frames_batch as j_frames_batch
    from repro_torch.data.synthetic import frames_batch, lm_batch

    cj, ct = _cfgs()
    got = frames_batch(0, 3, 4, 32, ct)
    want = j_frames_batch(0, 3, 4, 32, cj)
    assert got.keys() == want.keys()
    for k in got:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
    assert got["frames"].dtype == torch.float32 and got["tokens"].shape == (4, 8)
    assert abs(float(got["frames"].std()) - 0.1) < 0.01
    assert torch.equal(got["tokens"], lm_batch(0, 3, 4, 8, ct.vocab)["tokens"])
    again = frames_batch(0, 3, 4, 32, ct)
    assert all(torch.equal(got[k], again[k]) for k in got)
    assert not torch.equal(got["frames"], frames_batch(0, 4, 4, 32, ct)["frames"])
    assert frames_batch(0, 0, 1, 4, ct)["tokens"].shape == (1, 2)


@pytest.mark.parametrize("d", [32, 64, 1024, 4096])
def test_layernorm_mean_sums_in_the_reference_order(d):
    """On the CPU, LayerNorm's f32 mean equals XLA's bit for bit (windows
    of 32 summed in order, then the partials), on rows whose terms span
    ten decades, so the summation order shows; and on a row of an xnor
    product's few distinct values whose exact mean is one of them, the
    signs of x - mean (what the next sign quantizer keeps) equal the
    reference LayerNorm's."""
    from repro.nn.norms import LayerNorm as JLayerNorm
    from repro_torch.nn.norms import LayerNorm, _ordered_mean

    rng = np.random.default_rng(d)
    x = (rng.standard_normal((64, d))
         * np.exp(rng.uniform(-12, 12, (64, d)))).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: jnp.mean(v, axis=-1, keepdims=True))(
        jnp.asarray(x)))
    np.testing.assert_array_equal(_ordered_mean(torch.from_numpy(x)).numpy(), want)
    # alpha * s * acc, acc even integers summing to 0 per replica: the exact
    # mean is 0, and the elements with acc = 0 equal it
    acc = rng.choice([-6, -2, 0, 2, 6], size=(8, d // 4)).astype(np.float32)
    acc[:, -1] = -acc[:, :-1].sum(axis=1)
    row = (acc[:, None, :] * np.float32(0.37)
           * rng.uniform(0.5, 2, (8, 4, 1)).astype(np.float32)).reshape(8, d)
    ones, zeros = np.ones(d, np.float32), np.zeros(d, np.float32)
    got = LayerNorm(d, ModelContext(compute_dtype=torch.float32, device="cpu"))(
        {"scale": torch.from_numpy(ones), "bias": torch.from_numpy(zeros)},
        torch.from_numpy(row))
    ref = JLayerNorm(d, JModelContext(compute_dtype=jnp.float32))(
        {"scale": jnp.asarray(ones), "bias": jnp.asarray(zeros)}, jnp.asarray(row))
    np.testing.assert_array_equal(got.numpy() > 0, np.asarray(ref) > 0)
