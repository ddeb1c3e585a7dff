"""Port parity for the encoder-decoder family in the engine, at
``.reduced()`` size in f32: the port's ``BatchedEngine`` serves
seamless-m4t-large-v2 with its ENCODE phase (one padded encoder pass a
request, charged against the tick's prefill budget) and its read-only
cross-attention pool, and emits the JAX engine's greedy tokens, finish
reasons, token steps and tick count (the JAX engine with
``prefix_cache=False`` and ``telemetry=False``) on the same exported
params, under every compute path at each chunk size of
``test_encdec_serve.CHUNKS``, on that file's ragged sources. Also: the
port's own dense ``prefill`` + ``decode_step`` anchor gives the engine's
tokens; warm = cold; the caches are pools only; cross pages go back to
refcount 0; ``stats()`` reports both families as the JAX engine does; the
``submit`` and ``ServeConfig`` errors; both CLIs."""
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
from repro_torch.nn.context import SERVE, ModelContext
from repro_torch.serve.engine import BatchedEngine, ServeConfig
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.weights import params_from_numpy
from test_encdec_serve import CHUNKS, ENC_TOKENS, PROMPTS

torch.set_num_threads(2)
ARCH = "seamless-m4t-large-v2"
ENGINE = dict(n_slots=2, max_len=64, page_tokens=8, enc_tokens=ENC_TOKENS)
MAX_TOKENS = 6
PATHS = ("float", "xnor", "int8")


@functools.lru_cache(maxsize=None)
def _export():
    """(JAX reduced config, SERVE params from masters of PRNGKey(1))."""
    cfg = j_get_config(ARCH).reduced()
    tm = j_build_model(cfg, JModelContext(policy=cfg.tbn, mode=J_TRAIN,
                                          compute_dtype=jnp.float32))
    sm = j_build_model(cfg, JModelContext(policy=cfg.tbn, mode=J_SERVE,
                                          compute_dtype=jnp.float32,
                                          use_pallas=False))
    masters = j_mod.init_params(tm.specs(), jax.random.PRNGKey(1))
    return cfg, j_export(tm.specs(), sm.specs(), masters, cfg.tbn)


@functools.lru_cache(maxsize=None)
def _port_params():
    return params_from_numpy(jax.tree.map(np.asarray, _export()[1]), "cpu")


@functools.lru_cache(maxsize=None)
def _sources():
    """``test_encdec_serve.sources()``'s two ragged clips (11 and 5 frames),
    drawn the same way, at this file's d_model."""
    rng = np.random.default_rng(7)
    d = _export()[0].d_model
    return tuple(rng.standard_normal((n, d)).astype(np.float32) for n in (11, 5))


def _jobs(n=len(PROMPTS)):
    src = _sources()
    return [(PROMPTS[i % len(PROMPTS)], src[i % 2]) for i in range(n)]


def _results(reqs, ticks):
    return ([r.output for r in reqs], [r.finish_reason for r in reqs],
            [r.token_steps for r in reqs], ticks)


def _submit(eng, jobs, sampling):
    return [eng.submit(np.asarray(p, np.int32), sampling(max_tokens=MAX_TOKENS),
                       frames=f) for p, f in jobs]


@functools.lru_cache(maxsize=None)
def _reference(path, chunk, n_jobs=len(PROMPTS)):
    """The JAX engine's greedy (outputs, finish reasons, token steps, ticks)
    and its stats after the drain."""
    cfg_j, sp_j = _export()
    sm_j = j_build_model(cfg_j, JModelContext(policy=cfg_j.tbn, mode=J_SERVE,
                                              compute_dtype=jnp.float32,
                                              use_pallas=False, compute_path=path))
    eng = JBatchedEngine(sm_j, sp_j, JServeConfig(
        **ENGINE, chunk_tokens=chunk, prefix_cache=False, telemetry=False,
        compute_path=path))
    reqs = _submit(eng, _jobs(n_jobs), JSamplingParams)
    return _results(reqs, eng.run_until_drained()), eng.stats()


def _engine(path, chunk, **over):
    cfg = get_config(ARCH).reduced()
    sm = build_model(cfg, ModelContext(policy=cfg.tbn, mode=SERVE,
                                       compute_dtype=torch.float32,
                                       device="cpu", compute_path=path))
    return BatchedEngine(sm, _port_params(), ServeConfig(
        **{**ENGINE, **over}, chunk_tokens=chunk, compute_path=path))


def _serve(eng, n_jobs=len(PROMPTS)):
    reqs = _submit(eng, _jobs(n_jobs), SamplingParams)
    return _results(reqs, eng.run_until_drained())


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("path", PATHS)
def test_greedy_tokens_identical_to_reference_engine(path, chunk):
    eng = _engine(path, chunk)
    got = _serve(eng)
    want, _ = _reference(path, chunk)
    assert got == want
    st = eng.stats()
    assert st["encode_ticks"] == len(PROMPTS)
    assert st["decode_ticks"] > 0 and st["extend_ticks"] > 0


@pytest.mark.parametrize("path", PATHS)
def test_queued_requests_encode_in_admission_order_like_reference(path):
    """Five requests on two slots: admissions wait for free slots, each
    admission encodes on a later tick, one encode a tick."""
    got = _serve(_engine(path, 7), n_jobs=5)
    assert got == _reference(path, 7, n_jobs=5)[0]


def test_engine_tokens_equal_the_dense_anchor():
    """The port's own wall: EncDecModel.prefill + the dense decode_step,
    unpaged and unchunked, gives each request's engine tokens."""
    eng = _engine("float", 7)
    outs = _serve(eng)[0]
    sm, sp = eng.model, eng.params
    for (prompt, frames), out in zip(_jobs(), outs):
        logits, caches, lengths = sm.prefill(
            sp, {"frames": torch.from_numpy(frames)[None],
                 "tokens": torch.tensor([prompt])}, 64)
        ref = [int(logits.argmax(-1))]
        for _ in range(MAX_TOKENS - 1):
            logits, caches, lengths = sm.decode_step(
                sp, torch.tensor([[ref[-1]]]), caches, lengths)
            ref.append(int(logits.argmax(-1)))
        assert ref == out


@pytest.mark.parametrize("path", PATHS)
def test_warm_engine_gives_the_cold_tokens(path):
    """``warmup()`` runs the decode, extend and encode ticks with every
    per-tick input zeroed (no valid frame: every cross write lands on the
    scratch page); the warm engine then serves the cold tokens and ticks,
    and the pools' pages 0..n-1 are the cold engine's."""
    cold_eng = _engine(path, 7)
    cold = _serve(cold_eng)
    eng = _engine(path, 7)
    assert set(eng.warmup()) == {"decode_tick", "extend_tick", "encode_tick"}
    assert eng.aot_warm
    assert all(torch.isfinite(v).all() for _, v in mod.walk(eng.caches))
    assert _serve(eng) == cold
    for fam in ("self", "cross"):
        for name in ("k", "v"):
            a, b = eng.caches[fam][name], cold_eng.caches[fam][name]
            assert torch.equal(a[:, :-1], b[:, :-1]), (fam, name)


def test_caches_are_pools_only():
    """Both families are (L, pages + 1, page_tokens, K, hd) pools: no dense
    (n_slots, T) cross row anywhere."""
    eng = _engine("float", 7)
    cfg = eng.model.cfg
    hd = cfg.head_dim
    x_npp = -(-ENC_TOKENS // ENGINE["page_tokens"])
    want = {"self": ENGINE["n_slots"] * ENGINE["max_len"] // ENGINE["page_tokens"],
            "cross": (ENGINE["n_slots"] + 1) * x_npp}
    assert set(eng.caches) == {"self", "cross"}
    for fam, pages in want.items():
        for name in ("k", "v"):
            assert tuple(eng.caches[fam][name].shape) == (
                cfg.dec_layers, pages + 1, ENGINE["page_tokens"], cfg.n_kv, hd)
    assert eng.xpool.n_pages == want["cross"] and eng.x_npp == x_npp
    assert [f.name for f in eng.model.cache_families()] == ["self_attn", "cross_attn"]


def test_cross_pages_return_to_refcount_zero_and_stats_match_reference():
    eng = _engine("float", 7)
    seen = []
    reqs = _submit(eng, _jobs(), SamplingParams)
    eng.run_until_drained(on_tick=lambda e: seen.append(
        e.stats()["cache_families"]["cross_attn"]["in_use"]))
    assert all(r.done for r in reqs)
    # two slots each hold their source's pages: 11 frames = 2 pages, 5 = 1
    assert max(seen) == 3
    assert not eng.xpool.refcounts.any() and eng.xpool.free_pages == eng.xpool.n_pages
    assert eng.pool.free_pages == eng.pool.n_pages
    eng.xpool.check()
    st, st_j = eng.stats(), _reference("float", 7)[1]
    assert st["cache_families"] == st_j["cache_families"]
    assert st["encode_ticks"] == st_j["encode_ticks"] == len(PROMPTS)
    assert st["ticks"] == st_j["ticks"]


def test_submit_errors():
    eng = _engine("float", 7)
    d = eng.model.cfg.d_model
    with pytest.raises(ValueError, match="needs frames"):
        eng.submit([1, 2, 3])
    with pytest.raises(ValueError, match=r"frame count 17 outside \(0, enc_tokens=16\]"):
        eng.submit([1, 2, 3], frames=np.zeros((17, d), np.float32))
    with pytest.raises(ValueError, match="frame count 0 outside"):
        eng.submit([1, 2, 3], frames=np.zeros((0, d), np.float32))
    with pytest.raises(ValueError, match="frames must be"):
        eng.submit([1, 2, 3], frames=np.zeros((4, d + 1), np.float32))
    cfg = get_config("granite-8b").reduced()
    dec = BatchedEngine(
        build_model(cfg, ModelContext(policy=cfg.tbn, mode=SERVE,
                                      compute_dtype=torch.float32, device="cpu")),
        mod.init_params(build_model(cfg, ModelContext(
            policy=cfg.tbn, mode=SERVE, device="cpu")).specs(), 0, "cpu"),
        ServeConfig(n_slots=2, max_len=32, chunk_tokens=8, page_tokens=8))
    with pytest.raises(ValueError, match="DecoderLM has no encoder"):
        dec.submit([1, 2, 3], frames=np.zeros((4, cfg.d_model), np.float32))
    assert dec.xpool is None and dec.stats()["cache_families"].keys() == {"self_attn"}


@pytest.mark.parametrize("over,match", [
    (dict(enc_tokens=0), "enc_tokens must be >= 1"),
    (dict(cross_pages=0), "cross_pages must be >= 1"),
])
def test_serve_config_validation(over, match):
    with pytest.raises(ValueError, match=match):
        ServeConfig(**over)


def test_cross_pages_below_one_request_raise():
    with pytest.raises(ValueError, match="below one request's worth"):
        _engine("float", 7, cross_pages=1)


def test_serve_cli_serves_encdec(capsys):
    reqs = serve_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--requests", "3", "--max-tokens", "4",
                           "--max-len", "48", "--enc-tokens", "16", "--aot"])
    out = capsys.readouterr().out
    assert f"arch={ARCH}-smoke" in out and "encode_tick" in out
    # the CLI's prefix cache is on: the third request's source is the
    # first's, which the EncoderCache holds, so it maps in without an encode
    assert ("encode phase: 2 encode ticks of 16 frames (2 sources), 1/3 "
            "admissions reused a cached encoder output") in out
    assert all(r.done and len(r.output) == 4 for r in reqs)
    assert all(8 <= len(r.frames) <= 16 for r in reqs)


def test_train_cli_trains_seamless(tmp_path, capsys):
    final, history = train_cli.main([
        "--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "3",
        "--batch", "2", "--seq", "16", "--log-every", "1",
        "--ckpt-dir", str(tmp_path)])
    assert "done: 3 steps" in capsys.readouterr().out and final.step == 3
    assert np.isfinite([loss for _, loss in history]).all()
