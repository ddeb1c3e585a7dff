"""Port parity for the VLM family (chameleon-34b: a dense decoder with
QK-norm and early fusion) against the JAX package, at ``.reduced()`` size
in f32: param specs at full size and the ledger; ``prefill`` logits and
caches with image positions fused from ``image_embeds``; paged ``extend``
and ``decode_step`` logits (the QK-norm path) under every compute path;
``train_forward`` loss and every gradient leaf with ``image_mask`` /
``image_embeds``; the engine's greedy tokens, finish reasons, token steps
and tick count equal the JAX engine's under every compute path and chunk
size, warm = cold; both CLIs (rtol = atol = 1e-4)."""
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
from repro.serve.engine import BatchedEngine as JBatchedEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.sampling import SamplingParams as JSamplingParams
from repro.serve.weights import export_serving_params as j_export
from repro_torch.configs import build_model, get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.nn import module as mod
from repro_torch.nn.context import SERVE, TRAIN, ModelContext
from repro_torch.serve.engine import BatchedEngine, ServeConfig
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.weights import params_from_numpy
from test_chunked_prefill import CHUNKS

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "chameleon-34b"
PATHS = ("float", "xnor", "int8")
ENGINE = dict(n_slots=2, max_len=48, page_tokens=8)
PROMPT_LENS = (5, 11, 19)
MAX_TOKENS = 6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree):
    return {"/".join(p): v for p, v in mod.walk(tree)}


@functools.lru_cache(maxsize=None)
def _export():
    """JAX (cfg, TRAIN model, masters of PRNGKey(4), SERVE params) and the
    port's (cfg, TRAIN model, SERVE params of the same export)."""
    cj, ct = j_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    tm_j = j_build_model(cj, JModelContext(policy=cj.tbn, mode=J_TRAIN,
                                           compute_dtype=jnp.float32))
    sm_j = j_build_model(cj, JModelContext(policy=cj.tbn, mode=J_SERVE,
                                           compute_dtype=jnp.float32,
                                           use_pallas=False))
    masters = j_mod.init_params(tm_j.specs(), jax.random.PRNGKey(4))
    sp_j = j_export(tm_j.specs(), sm_j.specs(), masters, cj.tbn)
    tm = build_model(ct, ModelContext(policy=ct.tbn, mode=TRAIN,
                                      compute_dtype=torch.float32, device="cpu"))
    return (cj, tm_j, masters, sp_j), (ct, tm, params_from_numpy(_np(sp_j), "cpu"))


def _serve_models(path):
    (cj, *_), (ct, *_) = _export()
    sm_j = j_build_model(cj, JModelContext(policy=cj.tbn, mode=J_SERVE,
                                           compute_dtype=jnp.float32,
                                           use_pallas=False, compute_path=path))
    sm = build_model(ct, ModelContext(policy=ct.tbn, mode=SERVE,
                                      compute_dtype=torch.float32, device="cpu",
                                      compute_path=path))
    return sm_j, sm


def _fused_batch(b, s, d, vocab, seed=3):
    """Tokens with every third position an image position carrying a
    precomputed embedding."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "image_mask": (np.arange(s)[None, :] % 3 == 1).repeat(b, 0),
            "image_embeds": (0.1 * rng.standard_normal((b, s, d))).astype(np.float32)}


@pytest.mark.parametrize("mode", ["train", "serve"])
def test_full_size_specs_and_ledger_match_reference(mode):
    cj, ct = j_get_config(ARCH), get_config(ARCH)
    jctx = JModelContext(policy=cj.tbn, mode=J_TRAIN if mode == "train" else J_SERVE)
    tctx = ModelContext(policy=ct.tbn, mode=TRAIN if mode == "train" else SERVE,
                        device="cpu")
    jm, tm = j_build_model(cj, jctx), build_model(ct, tctx)
    js = {"/".join(p): s for p, s in j_mod._walk(jm.specs())}
    ts = {"/".join(p): s for p, s in mod.walk(tm.specs())}
    assert ts.keys() == js.keys()
    for k, s in ts.items():
        assert tuple(s.shape) == tuple(js[k].shape), k
    # q-norm and k-norm over the head dim, 128
    assert tuple(ts["seg0/mixer/qnorm/scale"].shape) == (48, 128)
    assert tctx.ledger.report().rows() == jctx.ledger.report().rows()


def test_prefill_with_image_positions_matches_reference():
    (cj, _, _, sp_j), (ct, _, sp) = _export()
    sm_j, sm = _serve_models("float")
    batch = _fused_batch(2, 9, ct.d_model, ct.vocab)
    lj, cj_, _ = sm_j.prefill(sp_j, {k: jnp.asarray(v) for k, v in batch.items()}, 16)
    with torch.no_grad():
        lt, ct_, _ = sm.prefill(sp, {k: torch.from_numpy(v) for k, v in batch.items()},
                                16)
        plain, _, _ = sm.prefill(sp, {"tokens": torch.from_numpy(batch["tokens"])}, 16)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(ct_[0][n].numpy(), np.asarray(cj_[0][n]), **TOL)
    assert not torch.allclose(lt, plain)      # the image rows changed the logits


@pytest.mark.parametrize("path", PATHS)
def test_paged_extend_and_decode_match_reference(path):
    (cj, _, _, sp_j), (ct, _, sp) = _export()
    sm_j, sm = _serve_models(path)
    pt, n_pages = 8, 12
    cj_ = sm_j.init_caches(2, 48, jnp.float32, page_tokens=pt, n_pages=n_pages)
    with torch.no_grad():
        ct_ = sm.init_caches(2, 48, torch.float32, page_tokens=pt, n_pages=n_pages)
        ptab = np.arange(12, dtype=np.int32).reshape(2, 6)[:, ::-1].copy()
        toks = np.random.default_rng(5).integers(0, ct.vocab, (2, 10)).astype(np.int32)
        n_new = np.array([10, 4], np.int32)
        lengths = np.zeros(2, np.int32)
        lj, cj_, nj = sm_j.extend(sp_j, jnp.asarray(toks), cj_, jnp.asarray(lengths),
                                  jnp.asarray(n_new), page_table=jnp.asarray(ptab))
        lt, ct_, nt = sm.extend(sp, torch.from_numpy(toks), ct_,
                                torch.from_numpy(lengths), torch.from_numpy(n_new),
                                page_table=torch.from_numpy(ptab))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        for step in range(3):
            nxt = np.asarray(jnp.argmax(lj, -1))[:, None].astype(np.int32)
            lj, cj_, nj = sm_j.decode_step(sp_j, jnp.asarray(nxt), cj_, nj,
                                           page_table=jnp.asarray(ptab))
            lt, ct_, nt = sm.decode_step(sp, torch.from_numpy(nxt), ct_, nt,
                                         page_table=torch.from_numpy(ptab))
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        for n in ("k", "v"):
            np.testing.assert_allclose(ct_[0][n][:, :-1].numpy(),
                                       np.asarray(cj_[0][n]), **TOL)


def test_train_forward_with_image_embeds_loss_and_grads_match_reference():
    (cj, tm_j, masters, _), (ct, tm, _) = _export()
    batch = _fused_batch(2, 12, ct.d_model, ct.vocab, seed=6)
    (loss_j, met_j), g_j = jax.value_and_grad(tm_j.train_forward, has_aux=True)(
        masters, {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_numpy(_np(masters), "cpu")
    paths, leaves = zip(*mod.walk(params))
    for v in leaves:
        v.requires_grad_()
    loss, met = tm.train_forward(params, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), **TOL)
    np.testing.assert_allclose(float(met["ce"].detach()), float(met_j["ce"]), **TOL)
    g_j = _leaves(_np(g_j))
    assert len(grads) == len(g_j)
    for path, g in zip(paths, grads):
        want = g_j["/".join(path)]
        np.testing.assert_allclose(
            g.numpy(), want, rtol=1e-4, atol=1e-4 * max(1.0, float(np.abs(want).max())),
            err_msg="/".join(path))


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in PROMPT_LENS]


def _results(reqs, ticks):
    return ([r.output for r in reqs], [r.finish_reason for r in reqs],
            [r.token_steps for r in reqs], ticks)


@functools.lru_cache(maxsize=None)
def _reference(path, chunk):
    (cj, _, _, sp_j), _ = _export()
    sm_j, _ = _serve_models(path)
    eng = JBatchedEngine(sm_j, sp_j, JServeConfig(
        **ENGINE, chunk_tokens=chunk, prefix_cache=False, telemetry=False,
        compute_path=path))
    reqs = [eng.submit(p, JSamplingParams(max_tokens=MAX_TOKENS))
            for p in _prompts(cj.vocab)]
    return _results(reqs, eng.run_until_drained())


def _engine(path, chunk):
    _, sm = _serve_models(path)
    return BatchedEngine(sm, _export()[1][2], ServeConfig(
        **ENGINE, chunk_tokens=chunk, compute_path=path))


def _serve(eng):
    reqs = [eng.submit(p, SamplingParams(max_tokens=MAX_TOKENS))
            for p in _prompts(eng.model.cfg.vocab)]
    return _results(reqs, eng.run_until_drained())


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("path", PATHS)
def test_greedy_tokens_identical_to_reference_engine(path, chunk):
    assert _serve(_engine(path, chunk)) == _reference(path, chunk)


@pytest.mark.parametrize("path", PATHS)
def test_warm_engine_gives_the_cold_tokens(path):
    eng = _engine(path, 7)
    assert set(eng.warmup()) == {"decode_tick", "extend_tick"}
    assert _serve(eng) == _reference(path, 7)


def test_serve_cli_serves_chameleon(capsys):
    reqs = serve_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--requests", "3", "--max-tokens", "4",
                           "--max-len", "48", "--aot"])
    out = capsys.readouterr().out
    assert f"arch={ARCH}-smoke" in out and "AOT warmup" in out
    assert all(r.done and len(r.output) == 4 for r in reqs)


def test_train_cli_trains_chameleon(tmp_path, capsys):
    """The CLI's VLM batches: tokens, an all-text image mask, zero image
    embeddings."""
    gen = train_cli.batch_fn(get_config(ARCH).reduced(), 0, 2, 16)
    b = gen(0)
    assert b["image_mask"].shape == (2, 16) and not b["image_mask"].any()
    assert b["image_embeds"].shape == (2, 16, 64)
    final, history = train_cli.main([
        "--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "3",
        "--batch", "2", "--seq", "16", "--log-every", "1",
        "--ckpt-dir", str(tmp_path)])
    assert "done: 3 steps" in capsys.readouterr().out and final.step == 3
    assert np.isfinite([loss for _, loss in history]).all()
