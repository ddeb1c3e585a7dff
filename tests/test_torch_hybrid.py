"""Port parity for the SSM and hybrid families at the model level, against
the JAX package in f32 (rtol = atol = 1e-4): the configs and their param
specs at full size (recurrentgemma-2b's 8 pattern cycles and two ``rec``
tails), the export and ledger, the sliding-window ring (a reduced window
of 8, prompts of 1, 7, 9 and 20 tokens streamed in chunks of 2, 7 and 16:
logits, ring rows and carries after every chunk, then decode steps), the
monolithic ``prefill`` (logits and every cache leaf), the per-slot cache
operations (``merge_caches``, ``reset_slot_caches``, snapshots), and
``train_forward``'s loss and every gradient leaf, for both reduced configs
and for recurrentgemma at ``n_layers = 5`` (one cycle and both tails)."""
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
from repro.nn.context import SERVE as J_SERVE
from repro.nn.context import TRAIN as J_TRAIN
from repro.nn.context import ModelContext as JModelContext
from repro.serve.weights import export_serving_params as j_export
from repro_torch.configs import build_model, get_config
from repro_torch.models import lm
from repro_torch.nn import module as mod
from repro_torch.nn.context import SERVE, TRAIN, ModelContext
from repro_torch.serve.weights import export_serving_params, params_from_numpy
from test_torch_weights import CONFIG_FIELDS

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
# (arch, n_layers override or None)
MODELS = [("mamba2-370m", None), ("recurrentgemma-2b", None),
          ("recurrentgemma-2b", 5)]
MODEL_IDS = ["mamba2", "recgemma", "recgemma-L5"]
ARCHS = ("mamba2-370m", "recurrentgemma-2b")


def _walk_j(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk_j(tree[k], path + (k,))
    elif tree is not None:
        yield path, tree


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return params_from_numpy(_np(tree), "cpu")


def _cfgs(arch, n_layers=None, reduced=True):
    cj, ct = j_get_config(arch), get_config(arch)
    if reduced:
        cj, ct = cj.reduced(), ct.reduced()
    if n_layers:
        cj = dataclasses.replace(cj, n_layers=n_layers)
        ct = dataclasses.replace(ct, n_layers=n_layers)
    return cj, ct


@functools.lru_cache(maxsize=None)
def _models(arch, n_layers=None):
    """JAX (cfg, TRAIN model, SERVE model, masters, SERVE params) and the
    port's (cfg, TRAIN model, SERVE model, SERVE params of the same
    export)."""
    cj, ct = _cfgs(arch, n_layers)
    tm_j = j_build_model(cj, JModelContext(policy=cj.tbn, mode=J_TRAIN,
                                           compute_dtype=jnp.float32))
    sm_j = j_build_model(cj, JModelContext(policy=cj.tbn, mode=J_SERVE,
                                           compute_dtype=jnp.float32,
                                           use_pallas=False))
    masters = j_mod.init_params(tm_j.specs(), jax.random.PRNGKey(2))
    sp_j = j_export(tm_j.specs(), sm_j.specs(), masters, cj.tbn)
    ctx = dict(policy=ct.tbn, compute_dtype=torch.float32, device="cpu")
    tm = build_model(ct, ModelContext(mode=TRAIN, **ctx))
    sm = build_model(ct, ModelContext(mode=SERVE, **ctx))
    return (cj, tm_j, sm_j, masters, sp_j), (ct, tm, sm, _t(sp_j))


def _as_dict(tree):
    """A list of per-segment caches as {"0": ..., "1": ...}."""
    return {str(i): c for i, c in enumerate(tree)} if isinstance(tree, list) else tree


def _close_trees(got, want, what=""):
    got, want = _as_dict(got), _as_dict(want)
    g = {"/".join(p): v for p, v in mod.walk(got)}
    w = {"/".join(map(str, p)): np.asarray(v) for p, v in _walk_j(want)}
    assert g.keys() == w.keys(), what
    for k, v in g.items():
        assert tuple(v.shape) == w[k].shape, (what, k)
        np.testing.assert_allclose(v.detach().float().numpy(), w[k],
                                   err_msg=f"{what} {k}", **TOL)


# --------------------------------------------------------------------------
# configs, specs, export
# --------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch, reduced):
    cj, ct = _cfgs(arch, reduced=reduced)
    for f in CONFIG_FIELDS + ("pattern",):
        assert getattr(ct, f) == getattr(cj, f), f
    assert dataclasses.asdict(ct.tbn) == dataclasses.asdict(cj.tbn)
    if cj.ssm is not None:
        assert dataclasses.asdict(ct.ssm) == dataclasses.asdict(cj.ssm)
    else:
        assert ct.ssm is None


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_specs_match_reference(arch, mode):
    """Every param leaf at full size, by path, shape and dtype (specs only,
    nothing is allocated)."""
    cj, ct = _cfgs(arch, reduced=False)
    jm = j_build_model(cj, JModelContext(
        policy=cj.tbn, mode=J_TRAIN if mode == "train" else J_SERVE))
    tm = build_model(ct, ModelContext(
        policy=ct.tbn, mode=TRAIN if mode == "train" else SERVE, device="cpu"))
    js = {"/".join(p): s for p, s in _walk_j(jm.specs())}
    ts = {"/".join(p): s for p, s in mod.walk(tm.specs())}
    assert ts.keys() == js.keys()
    for k, s in ts.items():
        assert tuple(s.shape) == tuple(js[k].shape), k
        assert str(s.dtype).removeprefix("torch.") == np.dtype(js[k].dtype).name, k
    if arch == "recurrentgemma-2b":
        kinds = [(type(s.block).__name__, s.n, s.scanned) for s in tm.segments]
        assert kinds == [("_PatternBlock", 8, True), ("Block", 1, False),
                         ("Block", 1, False)]
        assert [b.kind for b in tm.segments[0].block.blocks] == ["rec", "rec", "attn"]
        assert [s.block.kind for s in tm.segments[1:]] == ["rec", "rec"]
        assert not tm.has_full_attn and tm.has_recurrent_state
    else:
        assert [(s.block.kind, s.n) for s in tm.segments] == [("ssm", 48)]
        assert not tm.segments[0].block.has_ffn


@pytest.mark.parametrize("arch,n_layers", MODELS, ids=MODEL_IDS)
def test_export_matches_reference(arch, n_layers):
    (cj, tm_j, _, masters, sp_j), (ct, tm, sm, _) = _models(arch, n_layers)
    sp = export_serving_params(tm.specs(), sm.specs(), _t(masters), ct.tbn)
    want = {"/".join(p): np.asarray(v) for p, v in _walk_j(_np(sp_j))}
    got = {"/".join(p): v for p, v in mod.walk(sp)}
    assert got.keys() == want.keys()
    for k, v in got.items():
        if v.dtype == torch.int32:
            np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
        else:
            np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-6, err_msg=k)
    # the f32 SSD / RG-LRU parameters pass through the export unchanged
    small = [k for k in got if k.split("/")[-1] in
             ("conv_w", "conv_b", "A_log", "D", "dt_bias", "norm_scale", "lam")]
    assert small
    masters_np = _np(masters)
    for k in small:
        np.testing.assert_array_equal(
            got[k].numpy(),
            functools.reduce(lambda t, q: t[q], k.split("/"), masters_np))


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_ledger_matches_reference(arch, reduced):
    cj, ct = _cfgs(arch, reduced=reduced)
    jctx = JModelContext(policy=cj.tbn, mode=J_SERVE)
    tctx = ModelContext(policy=ct.tbn, mode=SERVE, device="cpu")
    j_build_model(cj, jctx)
    build_model(ct, tctx)
    jr, tr = jctx.ledger.report(), tctx.ledger.report()
    assert tr.rows() == jr.rows()
    assert tr.summary(ct.name) == jr.summary(cj.name)


# --------------------------------------------------------------------------
# the sliding-window ring
# --------------------------------------------------------------------------
@pytest.mark.parametrize("chunk", [2, 7, 16])
@pytest.mark.parametrize("prompt_len", [1, 7, 9, 20])
def test_windowed_ring_chunked_extend_matches_reference(prompt_len, chunk):
    """Reduced window 8 on a 32-token slot: the prompt streams in chunks
    beside a second slot that takes fewer columns each tick; after every
    chunk the logits, the ring rows and the RG-LRU carries equal the
    reference's; then three decode steps."""
    (cj, _, sm_j, _, sp_j), (ct, _, sm, sp) = _models("recurrentgemma-2b")
    assert ct.window == 8
    rng = np.random.default_rng(prompt_len * 100 + chunk)
    prompts = [rng.integers(0, ct.vocab, prompt_len),
               rng.integers(0, ct.vocab, prompt_len + 3)]
    caches_j = sm_j.init_caches(2, 32, jnp.float32)
    caches = sm.init_caches(2, 32, torch.float32)
    assert caches[0]["b2"]["k"].shape == (1, 2, 8, ct.n_kv, 16)
    lens = [0, 0]
    len_j = jnp.zeros((2,), jnp.int32)
    lengths = torch.zeros((2,), dtype=torch.int32)
    with torch.no_grad():
        while lens[0] < len(prompts[0]) or lens[1] < len(prompts[1]):
            block = np.zeros((2, chunk), np.int32)
            n_new = np.zeros((2,), np.int32)
            for s, p in enumerate(prompts):
                take = min(chunk if s == 0 else max(1, chunk - 1), len(p) - lens[s])
                block[s, :take] = p[lens[s]:lens[s] + take]
                n_new[s] = take
                lens[s] += take
            lg_j, caches_j, len_j = sm_j.extend(sp_j, jnp.asarray(block), caches_j,
                                                len_j, jnp.asarray(n_new))
            lg, caches, lengths = sm.extend(sp, torch.from_numpy(block).long(),
                                            caches, lengths, torch.from_numpy(n_new))
            live = n_new > 0
            np.testing.assert_allclose(lg.numpy()[live], np.asarray(lg_j)[live], **TOL)
            _close_trees(caches, caches_j, f"after {lens}")
        tok = np.asarray([[3], [5]], np.int32)
        for _ in range(3):
            lg_j, caches_j, len_j = sm_j.decode_step(sp_j, jnp.asarray(tok),
                                                     caches_j, len_j)
            lg, caches, lengths = sm.decode_step(sp, torch.from_numpy(tok).long(),
                                                 caches, lengths)
            np.testing.assert_allclose(lg.numpy(), np.asarray(lg_j), **TOL)
            _close_trees(caches, caches_j, "decode")
            tok = np.asarray(lg_j).argmax(-1)[:, None].astype(np.int32)


# --------------------------------------------------------------------------
# monolithic prefill, per-slot cache operations
# --------------------------------------------------------------------------
@pytest.mark.parametrize("prompt_len", [2, 9, 20])
@pytest.mark.parametrize("arch,n_layers", MODELS, ids=MODEL_IDS)
def test_prefill_then_decode_matches_reference(arch, n_layers, prompt_len):
    """Logits and every cache leaf of the monolithic prefill (a ring longer
    than its prompt is rolled into place), then dense-cache decode steps."""
    (cj, _, sm_j, _, sp_j), (ct, _, sm, sp) = _models(arch, n_layers)
    toks = np.random.default_rng(prompt_len).integers(
        0, ct.vocab, (2, prompt_len)).astype(np.int32)
    lg_j, caches_j, len_j = sm_j.prefill(sp_j, {"tokens": jnp.asarray(toks)}, 24)
    with torch.no_grad():
        lg, caches, lengths = sm.prefill(sp, {"tokens": torch.from_numpy(toks)}, 24)
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_j), **TOL)
    assert lengths.tolist() == np.asarray(len_j).tolist()
    _close_trees(caches, caches_j, "prefill")
    tok = np.asarray(lg_j).argmax(-1)[:, None].astype(np.int32)
    for _ in range(2):
        lg_j, caches_j, len_j = sm_j.decode_step(sp_j, jnp.asarray(tok), caches_j,
                                                 len_j)
        with torch.no_grad():
            lg, caches, lengths = sm.decode_step(sp, torch.from_numpy(tok).long(),
                                                 caches, lengths)
        np.testing.assert_allclose(lg.numpy(), np.asarray(lg_j), **TOL)
        tok = np.asarray(lg_j).argmax(-1)[:, None].astype(np.int32)
    _close_trees(caches, caches_j, "decode")


def test_dense_prefill_decode_matches_reference():
    """The monolithic anchor for the dense family too: granite-8b's prefill
    K/V padded to max_len, then decode steps on the dense slot rows."""
    (cj, _, sm_j, _, sp_j), (ct, _, sm, sp) = _models("granite-8b")
    toks = np.random.default_rng(4).integers(0, ct.vocab, (2, 7)).astype(np.int32)
    lg_j, caches_j, len_j = sm_j.prefill(sp_j, {"tokens": jnp.asarray(toks)}, 16)
    with torch.no_grad():
        lg, caches, lengths = sm.prefill(sp, {"tokens": torch.from_numpy(toks)}, 16)
        _close_trees(caches, caches_j, "prefill")
        tok = np.asarray([[1], [2]], np.int32)
        for _ in range(2):
            lg_j, caches_j, len_j = sm_j.decode_step(sp_j, jnp.asarray(tok),
                                                     caches_j, len_j)
            lg, caches, lengths = sm.decode_step(sp, torch.from_numpy(tok).long(),
                                                 caches, lengths)
            np.testing.assert_allclose(lg.numpy(), np.asarray(lg_j), **TOL)
    _close_trees(caches, caches_j, "decode")


def _tc(caches):
    """A JAX list of per-segment caches -> the port's, on the CPU."""
    return [_t(c) for c in caches]


def _random_caches(sm_j, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda v: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32)),
        sm_j.init_caches(3, 16, jnp.float32))


@pytest.mark.parametrize("arch,n_layers", MODELS, ids=MODEL_IDS)
def test_slot_cache_operations_match_reference(arch, n_layers):
    """``merge_caches`` (written into ``old`` in place), ``reset_slot_caches``
    (a slot index given as an int or as a 0-d tensor), and the snapshot and
    restore of one slot's per-slot rows."""
    (_, _, sm_j, _, _), (_, _, sm, _) = _models(arch, n_layers)
    old_j, new_j = _random_caches(sm_j, 1), _random_caches(sm_j, 2)
    keep = np.asarray([True, False, True])
    want = sm_j.merge_caches(old_j, new_j, jnp.asarray(keep))
    old, new = _tc(old_j), _tc(new_j)
    got = sm.merge_caches(old, new, torch.from_numpy(keep))
    assert all(a is b for (_, a), (_, b) in zip(mod.walk(got), mod.walk(old)))
    _close_trees(got, want, "merge")

    for slot in (1, torch.tensor(2)):
        want = sm_j.reset_slot_caches(old_j, int(slot))
        got = sm.reset_slot_caches(_tc(old_j), slot)
        _close_trees(got, want, "reset")
    untouched = _tc(old_j)
    sm.reset_slot_caches(untouched, torch.tensor(3))        # no such slot
    _close_trees(untouched, old_j, "reset past the slots")

    snap_j = sm_j.snapshot_slot_caches(old_j, 1)
    snap = sm.snapshot_slot_caches(_tc(old_j), 1)
    _close_trees(snap, snap_j, "snapshot")
    want = sm_j.restore_slot_caches(new_j, 0, snap_j)
    got = sm.restore_slot_caches(_tc(new_j), 0, snap)
    _close_trees(got, want, "restore")


def test_has_full_attn_and_recurrent_state_match_reference():
    for arch in ("granite-8b", "qwen2-moe-a2.7b", *ARCHS):
        (_, _, sm_j, _, _), (_, _, sm, _) = _models(arch)
        assert sm.has_full_attn == sm_j.has_full_attn, arch
        assert sm.has_recurrent_state == sm_j.has_recurrent_state, arch


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch,n_layers", MODELS, ids=MODEL_IDS)
def test_train_forward_loss_and_grads_match_reference(arch, n_layers):
    (cj, tm_j, _, masters, _), (ct, tm, _, _) = _models(arch, n_layers)
    toks = np.random.default_rng(3).integers(0, ct.vocab, (2, 16)).astype(np.int32)
    (loss_j, _), g_j = jax.value_and_grad(tm_j.train_forward, has_aux=True)(
        masters, {"tokens": jnp.asarray(toks)})
    params = _t(masters)
    paths, leaves = zip(*mod.walk(params))
    for v in leaves:
        v.requires_grad_()
    loss, met = tm.train_forward(params, {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), **TOL)
    g_j = _np(g_j)
    for path, g in zip(paths, grads):
        want = functools.reduce(lambda t, k: t[k], path, g_j)
        np.testing.assert_allclose(
            g.numpy(), want, rtol=1e-4, atol=1e-4 * max(1.0, float(np.abs(want).max())),
            err_msg="/".join(path))


def test_remat_none_gives_the_same_loss():
    (_, tm_j, _, masters, _), (ct, _, _, _) = _models("recurrentgemma-2b", 5)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, ct.vocab, (2, 8)).astype(np.int32))
    params = _t(masters)
    losses = []
    for remat in ("full", "none"):
        cfg = dataclasses.replace(ct, remat=remat)
        m = lm.DecoderLM(cfg, ModelContext(policy=cfg.tbn, mode=TRAIN,
                                           compute_dtype=torch.float32,
                                           device="cpu"))
        losses.append(float(m.train_forward(params, {"tokens": toks})[0]))
    assert losses[0] == losses[1]
