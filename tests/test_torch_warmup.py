"""The port's AOT warmup walls (counterparts of tests/test_warmup.py).

``BatchedEngine.warmup()`` captures the decode and extend ticks (CUDA
graphs on a card; on this host one eager run each through the same static
buffers, no graph). Held here at ``.reduced()`` size in f32: warm greedy
tokens and their ticks equal a cold port engine's and the JAX engine's
after its own ``warmup()`` (the exported params of ``PRNGKey(1)`` masters,
as tests/test_torch_dense_engine.py builds them); a mid-flight warmup
changes no engine state; stochastic rows repeat warm and cold; a failed
warmup names its entry point and shapes and leaves the engine cold; the
serve CLI's ``--aot``.
"""
import functools
import re

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
from repro_torch.nn.context import SERVE, ModelContext
from repro_torch.serve.engine import TRACE_COUNTS, BatchedEngine, ServeConfig
from repro_torch.serve.graphs import TickGraph
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.weights import params_from_numpy

torch.set_num_threads(2)
ENGINE = dict(n_slots=2, max_len=48, chunk_tokens=8, page_tokens=8)
PROMPT_LENS = (5, 11, 19)
MAX_TOKENS = 6
ENTRY_POINTS = {"decode_tick", "extend_tick"}
CASES = [("granite-8b", "float"), ("granite-8b", "xnor"), ("granite-8b", "int8"),
         ("qwen1.5-32b", "float"), ("minitron-8b", "float"),
         ("starcoder2-7b", "float")]


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
    return ([r.output for r in reqs], [r.token_steps for r in reqs], ticks)


@functools.lru_cache(maxsize=None)
def _reference(arch, path):
    """The JAX engine's greedy (outputs, token steps, ticks) after its own
    ``warmup()``."""
    cfg_j, sp_j = _export(arch)
    sm_j = j_build_model(cfg_j, JModelContext(policy=cfg_j.tbn, mode=J_SERVE,
                                              compute_dtype=jnp.float32,
                                              use_pallas=False, compute_path=path))
    eng = JBatchedEngine(sm_j, sp_j, JServeConfig(
        **ENGINE, prefix_cache=False, telemetry=False, compute_path=path))
    eng.warmup()
    assert eng.aot_warm
    reqs = [eng.submit(p, JSamplingParams(max_tokens=MAX_TOKENS))
            for p in _prompts(cfg_j.vocab)]
    return _results(reqs, eng.run_until_drained())


def _engine(arch="granite-8b", path="float", **kw):
    cfg = get_config(arch).reduced()
    sm = build_model(cfg, ModelContext(policy=cfg.tbn, mode=SERVE,
                                       compute_dtype=torch.float32,
                                       device="cpu", compute_path=path))
    return BatchedEngine(sm, _port_params(arch),
                         ServeConfig(**{**ENGINE, **kw}, compute_path=path))


def _serve(eng, params=None):
    reqs = [eng.submit(p, params or SamplingParams(max_tokens=MAX_TOKENS))
            for p in _prompts(eng.model.cfg.vocab)]
    return _results(reqs, eng.run_until_drained())


def _state(eng):
    """Copies of the state a tick reads: the pool pages a page table can map
    (the last page is the scratch sink of dropped writes, never read), the
    lengths and the last tokens."""
    n = eng.pool.n_pages
    pools = [{k: v[:, :n].clone() for k, v in c.items()} for c in eng.caches]
    return pools, eng.lengths.clone(), eng.tokens.clone()


def _assert_same_state(a, b):
    for pa, pb in zip(a[0], b[0], strict=True):
        assert pa.keys() == pb.keys()
        for k in pa:
            assert torch.equal(pa[k], pb[k]), k
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])


@pytest.mark.parametrize("arch,path", CASES)
def test_warm_and_cold_greedy_tokens_equal_reference_engine(arch, path):
    want = _reference(arch, path)
    cold = _engine(arch, path)
    got_cold = _serve(cold)
    warm = _engine(arch, path)
    assert set(warm.warmup()) == ENTRY_POINTS
    got_warm = _serve(warm)
    assert got_warm == got_cold == want
    assert warm.stats()["aot_warm"] and not cold.stats()["aot_warm"]
    if arch == "qwen1.5-32b":
        assert warm.caches[0]["k"].dtype == torch.int8
    assert warm.pool.used_pages == 0


def test_warmup_reports_seconds_and_a_second_call_is_a_no_op():
    eng = _engine()
    assert not eng.aot_warm and eng.stats()["aot_warm"] is False
    before = TRACE_COUNTS.copy()
    timings = eng.warmup()
    assert set(timings) == ENTRY_POINTS and all(t > 0 for t in timings.values())
    assert eng.aot_warm and eng.stats()["aot_warm"] is True
    # no graph on the CPU: each tick function ran once, eagerly
    assert TRACE_COUNTS - before == {"decode_tick": 1, "extend_tick": 1}
    graphs = dict(eng._graphs)
    after = TRACE_COUNTS.copy()
    assert eng.warmup() == timings
    assert TRACE_COUNTS == after
    assert all(eng._graphs[k] is g for k, g in graphs.items())
    assert all(g.graph is None for g in graphs.values())


def test_midflight_warmup_leaves_engine_state_unchanged():
    """Warm a granite engine with one slot decoding and one prefilling: the
    caches, lengths and tokens are unchanged, and the drain then emits a
    cold engine's tokens; every later tick goes through the tick graphs."""
    eng = _engine()
    reqs = [eng.submit(p, SamplingParams(max_tokens=MAX_TOKENS))
            for p in _prompts(eng.model.cfg.vocab)]
    for _ in range(3):
        eng.step()
    st = eng.stats()
    assert st["decode_ticks"] > 0 and int(eng.lengths.min()) > 0
    before = _state(eng)
    eng.warmup()
    _assert_same_state(before, _state(eng))
    counts = TRACE_COUNTS.copy()
    ticks = 3 + eng.run_until_drained()
    st = eng.stats()
    assert TRACE_COUNTS - counts == {"decode_tick": st["decode_ticks"] - 2,
                                     "extend_tick": st["extend_ticks"] - 3}
    assert _results(reqs, ticks) == _serve(_engine())


def test_stochastic_rows_repeat_warm_and_cold():
    """Sampling runs eagerly on the ticks' logits, warm or cold: rows with a
    temperature, a top-k and an explicit seed give the same tokens."""
    params = SamplingParams(max_tokens=MAX_TOKENS, temperature=0.9, top_k=20)
    seeded = SamplingParams(max_tokens=MAX_TOKENS, temperature=1.3, seed=11)
    runs = []
    for warm in (False, True):
        eng = _engine(temperature=0.7)
        if warm:
            eng.warmup()
        prompts = _prompts(eng.model.cfg.vocab)
        reqs = [eng.submit(prompts[0], params), eng.submit(prompts[1], seeded),
                eng.submit(prompts[2])]
        runs.append(_results(reqs, eng.run_until_drained()))
    assert runs[0] == runs[1]
    greedy = _serve(_engine())
    assert runs[0][0][0] != greedy[0][0]      # the rows did sample


@pytest.mark.parametrize("method,pattern", [
    ("decode_step", r"'decode_tick' \(tokens int64\[3,1\], lengths int32\[3\], "
                    r"ptab int32\[3,6\], active bool\[3\].*no capture today"),
    ("extend", r"'extend_tick' \(block int64\[3,8\], lengths int32\[3\], "
               r"n_new int32\[3\], ptab int32\[3,6\].*no capture today")])
def test_failed_warmup_names_entry_point_and_shapes(method, pattern):
    eng = _engine(n_slots=3)

    def boom(*args, **kwargs):
        raise ValueError("no capture today")

    setattr(eng.model, method, boom)
    with pytest.raises(RuntimeError, match=pattern):
        eng.warmup()
    assert not eng.aot_warm and not eng.stats()["aot_warm"]


def test_uncaptured_cuda_tick_graph_never_runs_eagerly():
    """The eager call is the CPU engine's branch only: on a CUDA device a
    tick graph that was not captured raises instead of calling its
    function."""
    calls = []
    graph = TickGraph("decode_tick", lambda: calls.append(1), {},
                      torch.device("cuda"))
    with pytest.raises(RuntimeError, match="'decode_tick' was not captured"):
        graph.run()
    assert not calls


def test_serve_cli_aot_flag(capsys):
    argv = ["--reduced", "--device", "cpu", "--requests", "2", "--max-tokens",
            "3", "--max-len", "32"]
    cold = serve_cli.main(argv)
    assert "AOT warmup" not in capsys.readouterr().out
    warm = serve_cli.main(argv + ["--aot"])
    out = capsys.readouterr().out
    assert re.search(r"^AOT warmup: decode_tick \d+\.\d\ds, extend_tick "
                     r"\d+\.\d\ds$", out, re.M), out
    assert [r.output for r in warm] == [r.output for r in cold]
    assert all(len(r.output) == 3 for r in warm)
