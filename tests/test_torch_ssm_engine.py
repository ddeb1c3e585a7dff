"""Port parity for the SSM and hybrid families in the engine, at
``.reduced()`` size in f32: the port's ``BatchedEngine`` emits the JAX
engine's greedy tokens, token for token and tick for tick, on the same
exported params (the JAX engine with ``prefix_cache=False`` and
``telemetry=False``) for mamba2-370m and recurrentgemma-2b (also at
``n_layers = 5``: one pattern cycle and both tails) under every compute
path at each chunk size of ``test_chunked_prefill.CHUNKS``, with prompts
longer than the reduced 8-token window. Neither model gets a page pool.
The warm engine (``warmup()``: on this host one eager run of each entry
point, ``reset_slot`` included, through the static buffers) gives the cold
tokens; a mid-flight warmup changes no state; a decode tick leaves every
inactive slot's per-slot rows bit-identical; ``params_from_numpy`` carries
the JAX masters; the streamed ``build_serving`` equals the export of the
whole master tree; and both CLIs take the two arch ids."""
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
from repro.serve.engine import BatchedEngine as JBatchedEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.sampling import SamplingParams as JSamplingParams
from repro.serve.weights import export_serving_params as j_export
from repro_torch.configs import build_model, get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.nn import module as mod
from repro_torch.nn.context import SERVE, TRAIN, ModelContext
from repro_torch.serve.engine import TRACE_COUNTS, BatchedEngine, ServeConfig
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.weights import export_serving_params, params_from_numpy
from test_chunked_prefill import CHUNKS

torch.set_num_threads(2)
ENGINE = dict(n_slots=2, max_len=48, page_tokens=8)
PROMPT_LENS = (5, 11, 19)
MAX_TOKENS = 6
PATHS = ("float", "xnor", "int8")
# (arch, n_layers override or None)
MODELS = [("mamba2-370m", None), ("recurrentgemma-2b", None),
          ("recurrentgemma-2b", 5)]
MODEL_IDS = ["mamba2", "recgemma", "recgemma-L5"]
ARCHS = ("mamba2-370m", "recurrentgemma-2b")


def _cfg(get, arch, n_layers):
    cfg = get(arch).reduced()
    return dataclasses.replace(cfg, n_layers=n_layers) if n_layers else cfg


@functools.lru_cache(maxsize=None)
def _export(arch, n_layers=None):
    """(JAX masters of PRNGKey(1), their SERVE export)."""
    cfg = _cfg(j_get_config, arch, n_layers)
    tm = j_build_model(cfg, JModelContext(policy=cfg.tbn, mode=J_TRAIN,
                                          compute_dtype=jnp.float32))
    sm = j_build_model(cfg, JModelContext(policy=cfg.tbn, mode=J_SERVE,
                                          compute_dtype=jnp.float32,
                                          use_pallas=False))
    masters = j_mod.init_params(tm.specs(), jax.random.PRNGKey(1))
    return masters, j_export(tm.specs(), sm.specs(), masters, cfg.tbn)


@functools.lru_cache(maxsize=None)
def _port_params(arch, n_layers=None):
    return params_from_numpy(jax.tree.map(np.asarray, _export(arch, n_layers)[1]),
                             "cpu")


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in PROMPT_LENS]


def _results(reqs, ticks):
    assert all(r.finish_reason == "length" for r in reqs)
    return ([r.output for r in reqs], [r.token_steps for r in reqs], ticks)


def _reference(arch, n_layers, path, chunk):
    """The JAX engine's greedy (outputs, token steps, ticks)."""
    cfg = _cfg(j_get_config, arch, n_layers)
    sm = j_build_model(cfg, JModelContext(policy=cfg.tbn, mode=J_SERVE,
                                          compute_dtype=jnp.float32,
                                          use_pallas=False, compute_path=path))
    eng = JBatchedEngine(sm, _export(arch, n_layers)[1], JServeConfig(
        **ENGINE, chunk_tokens=chunk, prefix_cache=False, telemetry=False,
        compute_path=path))
    reqs = [eng.submit(p, JSamplingParams(max_tokens=MAX_TOKENS))
            for p in _prompts(cfg.vocab)]
    return _results(reqs, eng.run_until_drained())


def _engine(arch, n_layers=None, path="float", chunk=7, n_slots=2):
    cfg = _cfg(get_config, arch, n_layers)
    sm = build_model(cfg, ModelContext(policy=cfg.tbn, mode=SERVE,
                                       compute_dtype=torch.float32,
                                       device="cpu", compute_path=path))
    return BatchedEngine(sm, _port_params(arch, n_layers), ServeConfig(
        **dict(ENGINE, n_slots=n_slots), chunk_tokens=chunk, compute_path=path))


def _serve(eng):
    reqs = [eng.submit(p, SamplingParams(max_tokens=MAX_TOKENS))
            for p in _prompts(eng.model.cfg.vocab)]
    return _results(reqs, eng.run_until_drained())


def _snapshot(eng):
    return [t.clone() for _, t in mod.walk({str(i): c for i, c in
                                             enumerate(eng.caches)})]


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("arch,n_layers", MODELS, ids=MODEL_IDS)
def test_greedy_tokens_identical_to_reference_engine(arch, n_layers, path, chunk):
    eng = _engine(arch, n_layers, path, chunk)
    assert eng.pool is None                       # no full attention, no pages
    got = _serve(eng)
    assert got == _reference(arch, n_layers, path, chunk)
    st = eng.stats()
    assert st["decode_ticks"] > 0 and st["extend_ticks"] > 0
    assert st["pool_pages"] == 0 and st["pages_in_use"] == 0


@pytest.mark.parametrize("arch,n_layers", MODELS, ids=MODEL_IDS)
def test_warm_engine_gives_the_cold_tokens(arch, n_layers):
    """``warmup()`` runs the decode tick, the extend tick and the slot reset
    with every per-tick input zeroed and no slot to reset; the warm engine
    then serves the cold engine's tokens and ticks, and its admissions
    reset through the ``reset_slot`` entry point."""
    cold = _serve(_engine(arch, n_layers))
    eng = _engine(arch, n_layers)
    assert set(eng.warmup()) == {"decode_tick", "extend_tick", "reset_slot"}
    assert eng.aot_warm
    before = TRACE_COUNTS["reset_slot"]
    assert _serve(eng) == cold
    assert TRACE_COUNTS["reset_slot"] - before == len(PROMPT_LENS)


@pytest.mark.parametrize("arch", ARCHS)
def test_midflight_warmup_changes_no_state(arch):
    eng = _engine(arch, chunk=4)
    reqs = [eng.submit(p, SamplingParams(max_tokens=MAX_TOKENS))
            for p in _prompts(eng.model.cfg.vocab)]
    for _ in range(4):           # one slot decoding, one mid-prefill
        eng.step()
    before, lengths = _snapshot(eng), eng.lengths.clone()
    eng.warmup()
    assert all(torch.equal(a, b) for a, b in zip(before, _snapshot(eng)))
    assert torch.equal(lengths, eng.lengths)
    eng.run_until_drained()
    cold = _engine(arch, chunk=4)
    want = [cold.submit(p, SamplingParams(max_tokens=MAX_TOKENS))
            for p in _prompts(cold.model.cfg.vocab)]
    cold.run_until_drained()
    assert [r.output for r in reqs] == [r.output for r in want]


@pytest.mark.parametrize("arch,n_layers", MODELS, ids=MODEL_IDS)
def test_decode_tick_leaves_inactive_slots_bit_identical(arch, n_layers):
    """One slot decodes while another prefills and a third is free: the
    decode tick changes no per-slot row (carries, conv tails, ring rows)
    of the inactive slots."""
    eng = _engine(arch, n_layers, chunk=3, n_slots=3)
    prompts = _prompts(eng.model.cfg.vocab)
    eng.submit(prompts[0][:2], SamplingParams(max_tokens=8))
    eng.submit(prompts[2], SamplingParams(max_tokens=8))
    eng.step()
    eng.step()
    assert eng._phase[:2] == ["decode", "prefill"] and eng._phase[2] is None
    before = {s: _rows(eng, s) for s in (0, 1, 2)}
    eng._run_decode([0])
    for s in (1, 2):
        assert all(torch.equal(a, b) for a, b in zip(before[s], _rows(eng, s))), s
    assert not all(torch.equal(a, b) for a, b in zip(before[0], _rows(eng, 0)))


def _rows(eng, slot):
    """Copies of one slot's rows of every per-slot cache leaf (the slot
    axis is 1 in a layer-stacked segment)."""
    return [t.select(1 if seg.scanned else 0, slot).clone()
            for seg, c in zip(eng.model.segments, eng.caches)
            for _, t in mod.walk(c)]


def test_params_from_numpy_carries_jax_masters():
    masters, _ = _export("recurrentgemma-2b")
    got = params_from_numpy(jax.tree.map(np.asarray, masters), "cpu")
    want = {"/".join(p): np.asarray(v) for p, v in _walk(masters)}
    leaves = {"/".join(p): v for p, v in mod.walk(got)}
    assert leaves.keys() == want.keys()
    for k, v in leaves.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    cfg = get_config("recurrentgemma-2b").reduced()
    tm = build_model(cfg, ModelContext(policy=cfg.tbn, mode=TRAIN,
                                       compute_dtype=torch.float32, device="cpu"))
    assert {"/".join(p) for p, _ in mod.walk(tm.specs())} == leaves.keys()


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_streamed_build_serving_equals_whole_tree_export(arch):
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


@pytest.mark.parametrize("aot", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_serves_arch(arch, aot, capsys):
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--requests", "3",
            "--max-tokens", "4", "--max-len", "48"]
    reqs = serve_cli.main(argv + (["--aot"] if aot else []))
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke" in out
    assert ("reset_slot" in out) == aot
    assert all(r.done and len(r.output) == 4 for r in reqs)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_trains_arch(arch, tmp_path, capsys):
    final, history = train_cli.main([
        "--arch", arch, "--reduced", "--device", "cpu", "--steps", "3",
        "--batch", "2", "--seq", "16", "--log-every", "1",
        "--ckpt-dir", str(tmp_path)])
    assert "done: 3 steps" in capsys.readouterr().out and final.step == 3
    assert np.isfinite([loss for _, loss in history]).all()
