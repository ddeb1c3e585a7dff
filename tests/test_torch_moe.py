"""Port parity for the MoE family at the layer and model level: the
configs, ``ExpertBank`` (specs and ``effective`` in every branch), the
``MoE`` serve path (the drop-free dispatch's ids and positions exactly,
the layer output at rtol = atol = 1e-5), the TRAIN path (its dispatch,
forward, Switch aux loss and every gradient leaf, with dropped tokens and
with several dispatch groups), the export of the ``(L, E, r, words)``
expert tiles (bit-identical to the reference's, and their round trip),
the bit ledger, and the reduced models' logits and train loss. The same
numpy inputs and weights go to the JAX package and to the port, in f32,
with the Pallas kernels off on the JAX side (their plain versions)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build_model as j_build_model
from repro.configs import get_config as j_get_config
from repro.core import policy as j_policy
from repro.core.packing import unpack_bits as j_unpack_bits
from repro.core.tiling import tile_vector as j_tile_vector
from repro.nn import module as j_mod
from repro.nn import moe as j_moe
from repro.nn.context import SERVE as J_SERVE
from repro.nn.context import TRAIN as J_TRAIN
from repro.nn.context import ModelContext as JModelContext
from repro.serve.weights import export_serving_params as j_export
from repro_torch.configs import ARCH_IDS, build_model, get_config
from repro_torch.core import policy as t_policy
from repro_torch.core.packing import unpack_bits
from repro_torch.nn import module as mod
from repro_torch.nn import moe
from repro_torch.nn.context import SERVE, TRAIN, ModelContext
from repro_torch.serve.weights import export_serving_params, params_from_numpy
from test_torch_weights import CONFIG_FIELDS

torch.set_num_threads(2)
MOE_ARCHS = ("qwen2-moe-a2.7b", "moonshot-v1-16b-a3b")
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL = 1e-4

# name -> (JAX policy, port policy, n_out, n_in) of one expert matrix
POLICIES = {
    "aligned": (j_policy.tbn_policy(p=8, min_size=1024, alpha_source="W"),
                t_policy.tbn_policy(p=8, min_size=1024, alpha_source="W"),
                64, 64),
    "aligned_A_layer": (
        j_policy.tbn_policy(p=4, min_size=1024, alpha_source="A",
                            alpha_mode="layer"),
        t_policy.tbn_policy(p=4, min_size=1024, alpha_source="A",
                            alpha_mode="layer"), 64, 64),
    "unaligned": (
        j_policy.tbn_policy(p=8, min_size=1, alpha_source="W",
                            require_aligned=False),
        t_policy.tbn_policy(p=8, min_size=1, alpha_source="W",
                            require_aligned=False), 36, 64),
    "unaligned_A": (
        j_policy.tbn_policy(p=8, min_size=1, alpha_source="A",
                            require_aligned=False),
        t_policy.tbn_policy(p=8, min_size=1, alpha_source="A",
                            require_aligned=False), 36, 64),
    "bwnn": (j_policy.bwnn_policy(), t_policy.bwnn_policy(), 48, 64),
    "fp32": (j_policy.fp32_policy(), t_policy.fp32_policy(), 48, 64),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return params_from_numpy(_np(tree), "cpu")


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _ctx_pair(jpol, tpol, mode):
    jctx = JModelContext(policy=jpol, mode=mode, compute_dtype=jnp.float32,
                         use_pallas=False)
    tctx = ModelContext(policy=tpol, mode=TRAIN if mode == J_TRAIN else SERVE,
                        compute_dtype=torch.float32, device="cpu")
    return jctx, tctx


def _check_specs(jspecs, tspecs):
    jl = {"/".join(map(str, p)): s for p, s in _walk_j(jspecs)}
    tl = {"/".join(p): s for p, s in mod.walk(tspecs)}
    assert jl.keys() == tl.keys()
    for k, js in jl.items():
        assert tuple(js.shape) == tuple(tl[k].shape), k
        assert np.dtype(js.dtype).name == str(tl[k].dtype).removeprefix("torch."), k


def _walk_j(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk_j(tree[k], path + (k,))
    else:
        yield path, tree


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_config_matches_reference(arch, reduced):
    cj, ct = j_get_config(arch), get_config(arch)
    if reduced:
        cj, ct = cj.reduced(), ct.reduced()
    for f in CONFIG_FIELDS:
        assert getattr(ct, f) == getattr(cj, f), f
    assert dataclasses.asdict(ct.moe) == dataclasses.asdict(cj.moe)
    assert dataclasses.asdict(ct.tbn) == dataclasses.asdict(cj.tbn)
    assert arch in ARCH_IDS


# --------------------------------------------------------------------------
# ExpertBank
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mode", [J_TRAIN, J_SERVE])
@pytest.mark.parametrize("case", sorted(POLICIES))
def test_expert_bank_specs_match_reference(case, mode):
    jpol, tpol, n_out, n_in = POLICIES[case]
    jctx, tctx = _ctx_pair(jpol, tpol, mode)
    jb = j_moe.ExpertBank(4, n_in, n_out, jctx, name="bank")
    tb = moe.ExpertBank(4, n_in, n_out, tctx, name="bank")
    _check_specs(jb.specs(), tb.specs())
    assert (jb.spec is None) == (tb.spec is None)
    if jb.spec is not None:
        assert dataclasses.asdict(jb.spec) == dataclasses.asdict(tb.spec)


@pytest.mark.parametrize("mode", [J_TRAIN, J_SERVE])
@pytest.mark.parametrize("case", sorted(POLICIES))
def test_expert_bank_effective_matches_reference(case, mode):
    """``effective`` in every branch: TRAIN masters through
    ``tiled_weight_rows`` (alpha from W or A), per-expert ``tiled_weight``
    (unaligned), ``bwnn_weight`` and the plain cast; SERVE row-packed
    (E, r, words) and flat (E, ceil(q/32)) tiles and the dense leaf."""
    jpol, tpol, n_out, n_in = POLICIES[case]
    jctx, tctx = _ctx_pair(jpol, tpol, mode)
    jb = j_moe.ExpertBank(4, n_in, n_out, jctx, name="bank")
    tb = moe.ExpertBank(4, n_in, n_out, tctx, name="bank")
    rng = np.random.default_rng(sorted(POLICIES).index(case))
    params = {}
    for path, spec in _walk_j(jb.specs()):
        if np.dtype(spec.dtype) == np.int32:
            v = rng.integers(-2**31, 2**31, size=spec.shape, dtype=np.int64)
            v = v.astype(np.int32)
        elif path[-1] == "alpha":
            v = (rng.random(spec.shape) + 0.1).astype(np.float32)
        else:
            v = rng.standard_normal(spec.shape).astype(np.float32)
        params[path[-1]] = v
    want = np.asarray(jb.effective(jax.tree.map(jnp.asarray, params)))
    got = tb.effective(params_from_numpy(params, "cpu"))
    assert tuple(got.shape) == (4, n_out, n_in) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_unpack_and_reconstruct_on_expert_axes():
    """``unpack_bits`` and ``reconstruct_from_tile`` take leading expert
    axes, equal to one expert at a time."""
    from repro_torch.core.tiling import plan_tiling, reconstruct_from_tile

    spec = plan_tiling((64, 96), p=8, min_size=1, alpha_source="W")
    rng = np.random.default_rng(4)
    words = torch.from_numpy(rng.integers(-2**31, 2**31, size=(3, 8, 3),
                                          dtype=np.int64).astype(np.int32))
    alpha = torch.from_numpy(rng.random((3, 8)).astype(np.float32))
    t = unpack_bits(words, 96).reshape(3, spec.q)
    got = reconstruct_from_tile(t, alpha, spec)
    for e in range(3):
        one = reconstruct_from_tile(unpack_bits(words[e], 96).reshape(-1),
                                    alpha[e], spec)
        assert torch.equal(got[e], one)


# --------------------------------------------------------------------------
# MoE layer, serve path
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _layers(arch, mode, **over):
    """(JAX MoE, port MoE) of the reduced config's MoE layer, f32."""
    cfg = get_config(arch).reduced()
    m = cfg.moe
    kw = dict(n_shared=m.n_shared, name="moe", gated=cfg.gated_mlp,
              activation=cfg.activation)
    kw.update(over)
    jctx, tctx = _ctx_pair(j_get_config(arch).reduced().tbn, cfg.tbn, mode)
    return (j_moe.MoE(cfg.d_model, m.d_ff_expert, m.n_experts, m.top_k, jctx, **kw),
            moe.MoE(cfg.d_model, m.d_ff_expert, m.n_experts, m.top_k, tctx, **kw))


def _masters(jm, key=0):
    return j_mod.init_params(jm.specs(), jax.random.PRNGKey(key))


def _serve_params(arch, key=0, **over):
    jt, _ = _layers(arch, J_TRAIN, **over)
    js, ts = _layers(arch, J_SERVE, **over)
    sp_j = j_export(jt.specs(), js.specs(), _masters(jt, key),
                    get_config(arch).reduced().tbn)
    return js, ts, sp_j


def _top_idx(rng, tl, e, k):
    return np.stack([rng.permutation(e)[:k] for _ in range(tl)]).astype(np.int32)


@pytest.mark.parametrize("tl", [1, 4, 13, 40])
def test_dispatch_serve_ids_and_positions_equal(tl):
    js, ts, _ = _serve_params("qwen2-moe-a2.7b")
    rng = np.random.default_rng(tl)
    xg = rng.standard_normal((tl, ts.d_model)).astype(np.float32)
    top = _top_idx(rng, tl, ts.n_experts, ts.top_k)
    xbuf_j, (fe_j, pos_j) = js._dispatch_serve(jnp.asarray(xg), jnp.asarray(top))
    xbuf, (fe, pos) = ts._dispatch_serve(torch.from_numpy(xg),
                                         torch.from_numpy(top).long())
    np.testing.assert_array_equal(fe.numpy(), np.asarray(fe_j))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(pos_j))
    np.testing.assert_array_equal(xbuf.numpy(), np.asarray(xbuf_j))


def test_top_k_breaks_ties_to_the_lower_index():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    vals, idx = moe.top_k_lower_first(probs, 3)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))


SERVE_CASES = [("qwen2-moe-a2.7b", (2, 3), {}), ("qwen2-moe-a2.7b", (4, 8), {}),
               ("moonshot-v1-16b-a3b", (1, 5), {}),
               ("qwen2-moe-a2.7b", (2, 4), dict(gated=False, activation="relu2"))]


@pytest.mark.parametrize("arch,shape,over", SERVE_CASES,
                         ids=[f"{a}-{s[0]}x{s[1]}-{len(o)}" for a, s, o in SERVE_CASES])
def test_serve_call_matches_reference(arch, shape, over):
    js, ts, sp_j = _serve_params(arch, **over)
    rng = np.random.default_rng(shape[1])
    x = rng.standard_normal((*shape, ts.d_model)).astype(np.float32)
    y_j, aux_j = js(sp_j, jnp.asarray(x))
    with torch.no_grad():
        y, aux = ts(_t(sp_j), torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **TOL)
    assert float(aux) == float(aux_j) == 0.0


def test_serve_output_is_independent_of_batch_neighbours():
    """A token's serve output is the same alone and among others (the
    drop-free dispatch's promise), up to the row blocking of the CPU
    matmuls (a product's rows may sum in another order at another m)."""
    _, ts, sp_j = _serve_params("qwen2-moe-a2.7b")
    sp = _t(sp_j)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 9, ts.d_model)).astype(np.float32))
    with torch.no_grad():
        whole = ts(sp, x)[0]
        parts = torch.cat([ts(sp, x[:, i:i + 1])[0] for i in range(9)], dim=1)
    np.testing.assert_allclose(whole.numpy(), parts.numpy(), rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# MoE layer, TRAIN path
# --------------------------------------------------------------------------
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_train_dispatch_matches_reference(cf):
    jt, tt = _layers("qwen2-moe-a2.7b", J_TRAIN, capacity_factor=cf)
    tl = 64
    rng = np.random.default_rng(11)
    xg = rng.standard_normal((tl, tt.d_model)).astype(np.float32)
    top = _top_idx(rng, tl, tt.n_experts, tt.top_k)
    gates = rng.random((tl, tt.top_k)).astype(np.float32)
    cap = tt._capacity(tl)
    assert cap == int(max(8, -(-int(np.ceil(cf * tt.top_k * tl / tt.n_experts)) // 8) * 8))
    xbuf_j, meta_j = jt._dispatch(jnp.asarray(xg), jnp.asarray(top),
                                  jnp.asarray(gates), cap)
    xbuf, meta = tt._dispatch(torch.from_numpy(xg), torch.from_numpy(top).long(),
                              torch.from_numpy(gates), cap)
    np.testing.assert_array_equal(xbuf.numpy(), np.asarray(xbuf_j))
    for got, want in zip(meta, meta_j):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    dropped = int((meta[0] == tt.n_experts).sum())
    assert (dropped > 0) == (cf < 1), dropped


def _train_loss_j(jm):
    def f(params, x, proj):
        y, aux = jm(params, x)
        return jnp.sum(y * proj) + aux, aux
    return jax.value_and_grad(f, argnums=(0, 1), has_aux=True)


TRAIN_CASES = [("qwen2-moe-a2.7b", (2, 16), 1.25, 1),
               ("moonshot-v1-16b-a3b", (3, 7), 1.25, 1),
               ("qwen2-moe-a2.7b", (1, 96), 0.5, 1),      # tokens dropped
               ("qwen2-moe-a2.7b", (8, 1024), 0.5, 8)]    # 8 dispatch groups


@pytest.mark.parametrize("arch,shape,cf,groups", TRAIN_CASES,
                         ids=["qwen", "moonshot", "drops", "groups8"])
def test_train_forward_aux_and_grads_match_reference(arch, shape, cf, groups):
    jt, tt = _layers(arch, J_TRAIN, capacity_factor=cf)
    assert tt._n_groups(shape[0] * shape[1]) == jt._n_groups(shape[0] * shape[1]) == groups
    masters = _np(_masters(jt, key=5))
    rng = np.random.default_rng(shape[1])
    x = rng.standard_normal((*shape, tt.d_model)).astype(np.float32)
    proj = rng.standard_normal((*shape, tt.d_model)).astype(np.float32)
    (loss_j, aux_j), (g_j, gx_j) = _train_loss_j(jt)(
        jax.tree.map(jnp.asarray, masters), jnp.asarray(x), jnp.asarray(proj))

    params = params_from_numpy(masters, "cpu")
    paths, leaves = zip(*mod.walk(params))
    xt = torch.from_numpy(x).requires_grad_()
    for v in leaves:
        v.requires_grad_()
    y, aux = tt(params, xt)
    loss = (y * torch.from_numpy(proj)).sum() + aux
    grads = torch.autograd.grad(loss, (*leaves, xt))
    np.testing.assert_allclose(float(aux.detach()), float(aux_j), rtol=GRAD_RTOL)
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=GRAD_RTOL)
    for path, g in zip(paths + (("x",),), grads):
        want = np.asarray(gx_j if path == ("x",) else _leaf(g_j, path))
        np.testing.assert_allclose(
            g.numpy(), want, rtol=GRAD_RTOL,
            atol=GRAD_RTOL * float(np.abs(want).max()), err_msg="/".join(path))


# --------------------------------------------------------------------------
# models: export, ledger, logits, train loss
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _j_models(arch, key=0):
    cfg = j_get_config(arch).reduced()
    tm = j_build_model(cfg, JModelContext(policy=cfg.tbn, mode=J_TRAIN,
                                          compute_dtype=jnp.float32))
    sm = j_build_model(cfg, JModelContext(policy=cfg.tbn, mode=J_SERVE,
                                          compute_dtype=jnp.float32,
                                          use_pallas=False))
    masters = j_mod.init_params(tm.specs(), jax.random.PRNGKey(key))
    return cfg, tm, sm, masters, j_export(tm.specs(), sm.specs(), masters, cfg.tbn)


def _t_models(arch):
    cfg = get_config(arch).reduced()
    ctx = dict(policy=cfg.tbn, compute_dtype=torch.float32, device="cpu")
    return (cfg, build_model(cfg, ModelContext(mode=TRAIN, **ctx)),
            build_model(cfg, ModelContext(mode=SERVE, **ctx)))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_export_of_expert_tiles_is_bit_identical(arch):
    """The port's export of the JAX masters equals the reference's leaf for
    leaf: (L, E, r, words) expert tiles and their alphas, the unstacked
    ``dense0`` segment where the config has one; and each expert's shipped
    rows unpack to ``tile_vector`` of its master (the reference's round
    trip, ``test_moe_serve.py``)."""
    cfg_j, tm_j, _, masters_j, sp_j = _j_models(arch)
    cfg, tm, sm = _t_models(arch)
    sp = export_serving_params(tm.specs(), sm.specs(), _t(masters_j), cfg.tbn)
    want = {"/".join(p): np.asarray(v) for p, v in _walk_j(_np(sp_j))}
    got = {"/".join(p): v for p, v in mod.walk(sp)}
    assert got.keys() == want.keys()
    for k, v in got.items():
        if v.dtype == torch.int32:
            np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
        else:
            np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-6, err_msg=k)
    stack = "seg1" if cfg.moe.first_dense else "seg0"
    if cfg.moe.first_dense:
        assert sp["seg0"]["ffn"]["up"]["tile"].ndim == 2     # one layer, no L
    tile = sp[stack]["ffn"]["up"]["tile"]
    n_moe = cfg.n_layers - int(cfg.moe.first_dense)
    assert tile.ndim == 4 and tile.shape[:2] == (n_moe, cfg.moe.n_experts)
    w_bank = np.asarray(masters_j[stack]["ffn"]["up"]["w"])     # (L, E, f, d)
    spec = cfg_j.tbn.spec_for(tuple(w_bank.shape[2:]))
    for layer in range(w_bank.shape[0]):
        for e in range(w_bank.shape[1]):
            t_ref = np.asarray(j_tile_vector(jnp.asarray(w_bank[layer, e]), spec))
            t_got = unpack_bits(tile[layer, e], w_bank.shape[-1]).reshape(-1)
            np.testing.assert_array_equal(t_got.numpy(), t_ref)
            np.testing.assert_array_equal(
                t_got.numpy(), np.asarray(j_unpack_bits(
                    jnp.asarray(want[f"{stack}/ffn/up/tile"][layer, e]),
                    w_bank.shape[-1])).reshape(-1))


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_ledger_bits_per_param_match_reference(arch, reduced):
    cj, ct = j_get_config(arch), get_config(arch)
    if reduced:
        cj, ct = cj.reduced(), ct.reduced()
    jctx = JModelContext(policy=cj.tbn, mode=J_SERVE)
    tctx = ModelContext(policy=ct.tbn, mode=SERVE, device="cpu")
    j_build_model(cj, jctx)
    build_model(ct, tctx)
    jr, tr = jctx.ledger.report(), tctx.ledger.report()
    assert [r["name"] for r in tr.rows()] == [r["name"] for r in jr.rows()]
    assert tr.rows() == jr.rows()
    assert tr.summary(ct.name) == jr.summary(cj.name)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_extend_then_decode_logits_match_reference(arch):
    cfg_j, _, sm_j, _, sp_j = _j_models(arch)
    cfg, _, sm = _t_models(arch)
    sp = _t(sp_j)
    b, pt, n_pages, npp = 2, 8, 12, 6
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab, size=(b, 8)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab, size=(b, 1)).astype(np.int32)
    ptab = rng.permutation(n_pages)[: b * npp].reshape(b, npp).astype(np.int32)
    n_new = np.asarray([8, 5], np.int32)
    caches_j = sm_j.init_caches(b, npp * pt, jnp.float32, page_tokens=pt,
                                n_pages=n_pages)
    le_j, caches_j, len_j = sm_j.extend(
        sp_j, jnp.asarray(tokens), caches_j, jnp.zeros((b,), jnp.int32),
        jnp.asarray(n_new), page_table=jnp.asarray(ptab))
    ld_j, _, _ = sm_j.decode_step(sp_j, jnp.asarray(nxt), caches_j, len_j,
                                  page_table=jnp.asarray(ptab))
    t = torch.from_numpy
    caches = sm.init_caches(b, npp * pt, torch.float32, page_tokens=pt,
                           n_pages=n_pages)
    if cfg.moe.first_dense:      # dense0's pool carries no layer axis
        assert caches[0]["k"].ndim == caches[1]["k"].ndim - 1
    with torch.no_grad():
        le, caches, lengths = sm.extend(sp, t(tokens).long(), caches,
                                        torch.zeros((b,), dtype=torch.int32),
                                        t(n_new), t(ptab))
        ld, _, _ = sm.decode_step(sp, t(nxt).long(), caches, lengths, t(ptab))
    np.testing.assert_allclose(le.numpy(), np.asarray(le_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ld_j), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_forward_loss_and_aux_match_reference(arch):
    """``train_forward`` returns ce + 0.01 * aux with {"ce", "aux"}, aux
    summed over the MoE layers; every gradient leaf at rtol 1e-4."""
    cfg_j, tm_j, _, masters_j, _ = _j_models(arch)
    cfg, tm, _ = _t_models(arch)
    toks = np.random.default_rng(8).integers(0, cfg.vocab, size=(2, 16)).astype(np.int32)
    (loss_j, met_j), g_j = jax.value_and_grad(tm_j.train_forward, has_aux=True)(
        masters_j, {"tokens": jnp.asarray(toks)})
    params = _t(masters_j)
    paths, leaves = zip(*mod.walk(params))
    for v in leaves:
        v.requires_grad_()
    loss, met = tm.train_forward(params, {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, leaves)
    assert float(met["aux"].detach()) > 0
    for key in ("ce", "aux"):
        np.testing.assert_allclose(float(met[key].detach()), float(met_j[key]),
                                   rtol=GRAD_RTOL)
    np.testing.assert_allclose(float(loss.detach()),
                               float(met["ce"] + 0.01 * met["aux"]), rtol=1e-6)
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=GRAD_RTOL)
    for path, g in zip(paths, grads):
        want = np.asarray(_leaf(g_j, path))
        np.testing.assert_allclose(
            g.numpy(), want, rtol=GRAD_RTOL,
            atol=GRAD_RTOL * float(np.abs(want).max()), err_msg="/".join(path))
