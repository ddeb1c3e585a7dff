"""Port parity for the MoE family in the engine, at ``.reduced()`` size in
f32: the port's ``BatchedEngine`` emits the JAX engine's greedy tokens,
token for token and tick for tick, on the same exported params (the JAX
engine with ``prefix_cache=False`` and ``telemetry=False``) for
qwen2-moe-a2.7b under every compute path at each chunk size of
``test_chunked_prefill.CHUNKS``, and for moonshot-v1-16b-a3b (its
``dense0`` layer and int8 K/V cache) under every compute path; the port's
warm engine (``warmup()``: on this host one eager run of each tick through
the static buffers) gives the cold tokens; the streamed ``build_serving``
equals the export of the whole master tree; and both CLIs take the MoE
arch ids."""
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
from repro_torch.serve.weights import export_serving_params, params_from_numpy
from test_chunked_prefill import CHUNKS

torch.set_num_threads(2)
ENGINE = dict(n_slots=2, max_len=48, page_tokens=8)
PROMPT_LENS = (5, 11, 19)
MAX_TOKENS = 6
PATHS = ("float", "xnor", "int8")


@functools.lru_cache(maxsize=None)
def _export(arch):
    """(JAX reduced config, SERVE params from masters of PRNGKey(1))."""
    cfg = j_get_config(arch).reduced()
    tm = j_build_model(cfg, JModelContext(policy=cfg.tbn, mode=J_TRAIN,
                                          compute_dtype=jnp.float32))
    sm = j_build_model(cfg, JModelContext(policy=cfg.tbn, mode=J_SERVE,
                                          compute_dtype=jnp.float32,
                                          use_pallas=False))
    masters = j_mod.init_params(tm.specs(), jax.random.PRNGKey(1))
    return cfg, j_export(tm.specs(), sm.specs(), masters, cfg.tbn)


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return params_from_numpy(jax.tree.map(np.asarray, _export(arch)[1]), "cpu")


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in PROMPT_LENS]


def _results(reqs, ticks):
    assert all(r.finish_reason == "length" for r in reqs)
    return ([r.output for r in reqs], [r.token_steps for r in reqs], ticks)


def _reference(arch, path, chunk):
    """The JAX engine's greedy (outputs, token steps, ticks)."""
    cfg_j, sp_j = _export(arch)
    sm_j = j_build_model(cfg_j, JModelContext(policy=cfg_j.tbn, mode=J_SERVE,
                                              compute_dtype=jnp.float32,
                                              use_pallas=False, compute_path=path))
    eng = JBatchedEngine(sm_j, sp_j, JServeConfig(
        **ENGINE, chunk_tokens=chunk, prefix_cache=False, telemetry=False,
        compute_path=path))
    reqs = [eng.submit(p, JSamplingParams(max_tokens=MAX_TOKENS))
            for p in _prompts(cfg_j.vocab)]
    return _results(reqs, eng.run_until_drained())


def _engine(arch, path, chunk):
    cfg = get_config(arch).reduced()
    sm = build_model(cfg, ModelContext(policy=cfg.tbn, mode=SERVE,
                                       compute_dtype=torch.float32,
                                       device="cpu", compute_path=path))
    return BatchedEngine(sm, _port_params(arch), ServeConfig(
        **ENGINE, chunk_tokens=chunk, compute_path=path))


def _serve(eng):
    reqs = [eng.submit(p, SamplingParams(max_tokens=MAX_TOKENS))
            for p in _prompts(eng.model.cfg.vocab)]
    return _results(reqs, eng.run_until_drained())


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("path", PATHS)
def test_qwen2_moe_greedy_tokens_identical_to_reference_engine(path, chunk):
    eng = _engine("qwen2-moe-a2.7b", path, chunk)
    got = _serve(eng)
    assert got == _reference("qwen2-moe-a2.7b", path, chunk)
    st = eng.stats()
    assert st["decode_ticks"] > 0 and st["extend_ticks"] > 0
    assert st["pages_in_use"] == 0 and eng.pool.free_pages == eng.pool.n_pages


@pytest.mark.parametrize("path", PATHS)
def test_moonshot_int8_kv_greedy_tokens_identical_to_reference_engine(path):
    eng = _engine("moonshot-v1-16b-a3b", path, 8)
    # dense0 (one unstacked layer), then the stacked MoE layers; int8 K/V
    assert [c["k"].ndim for c in eng.caches] == [4, 5]
    assert all(c["k"].dtype == torch.int8 and c["ks"].dtype == torch.float32
               for c in eng.caches)
    assert _serve(eng) == _reference("moonshot-v1-16b-a3b", path, 8)


@pytest.mark.parametrize("arch,path", [("qwen2-moe-a2.7b", "float"),
                                       ("qwen2-moe-a2.7b", "xnor"),
                                       ("moonshot-v1-16b-a3b", "float")])
def test_warm_engine_gives_the_cold_tokens(arch, path):
    """``warmup()`` runs both ticks with every per-tick input zeroed (the
    MoE routes the padding tokens too, and its writes land on the scratch
    page); the warm engine then serves the cold engine's tokens and ticks."""
    cold = _serve(_engine(arch, path, 7))
    eng = _engine(arch, path, 7)
    assert set(eng.warmup()) == {"decode_tick", "extend_tick"}
    assert eng.aot_warm
    assert _serve(eng) == cold


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "moonshot-v1-16b-a3b"])
def test_streamed_build_serving_equals_whole_tree_export(arch):
    """``build_serving`` builds, exports and frees one master leaf at a time
    (the (L, E, n_out, n_in) expert leaves, and dense0's unstacked ones):
    its SERVE tree equals the export of ``init(seed)`` leaf for leaf."""
    cfg = get_config(arch).reduced()
    sm, sp, master_b = serve_cli.build_serving(cfg, device="cpu", seed=3,
                                               compute_dtype=torch.float32)
    tm = build_model(cfg, ModelContext(policy=cfg.tbn, mode=TRAIN,
                                       compute_dtype=torch.float32, device="cpu"))
    want = export_serving_params(tm.specs(), sm.specs(), tm.init(3), cfg.tbn)
    got_l, want_l = dict(mod.walk(sp)), dict(mod.walk(want))
    assert got_l.keys() == want_l.keys()
    for k, v in got_l.items():
        assert torch.equal(v, want_l[k]), k
    assert master_b == sum(v.numel() * 4 for _, v in mod.walk(tm.init(3)))


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "moonshot-v1-16b-a3b"])
def test_serve_cli_serves_moe_arch(arch, capsys):
    reqs = serve_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--requests", "3", "--max-tokens", "4",
                           "--max-len", "48", "--aot"])
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke" in out and "AOT warmup" in out
    assert all(r.done and len(r.output) == 4 for r in reqs)


def test_train_cli_trains_qwen2_moe(tmp_path, capsys):
    final, history = train_cli.main([
        "--arch", "qwen2-moe-a2.7b", "--reduced", "--device", "cpu",
        "--steps", "3", "--batch", "2", "--seq", "16", "--log-every", "1",
        "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "done: 3 steps" in out and final.step == 3
    assert [s for s, _ in history] == [1, 2, 3]
    assert np.isfinite([loss for _, loss in history]).all()
