"""Warm ticks and the tick control of a meshed engine on gloo ranks on the
CPU, against the JAX package's engine on one device.

One job of two ``tests/torch_mesh_worker.py`` ranks, started once for the
module, serves granite-8b ``.reduced()`` (2 layers, f32; the masters of
``PRNGKey(0)`` exported by the JAX package, through ``params_from_numpy``)
under the meshes (1, 2) and (2, 1):

* ``warmup()`` on every rank records each entry point's collectives
  (kind, mesh axis, shape, dtype): the same sequence on each rank, one
  all_gather over "model" per tiled layer and the head under (1, 2), and
  one a layer of the attention output by heads (each rank attends on 2 of
  the 4 heads), none under (2, 1), where no tile or head splits;
* the warm engine's greedy tokens, finish reasons, token steps and ticks
  under float, xnor and int8 equal the JAX engine's, on every rank (the
  first rank admits, the other follows it), with no eager tick counted;
* the tick control keeps the ranks equal through a prefix hit, a
  preemption and resume, and a mid-flight abort (``control_script``):
  tokens, finish reasons, token steps, the engine's counters and its page
  table equal on both ranks and equal the port's engine on one device.
"""
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
from repro_torch.nn.context import SERVE, ModelContext
from repro_torch.serve.engine import BatchedEngine, ServeConfig
from repro_torch.serve.weights import params_from_numpy
from torch_mesh_worker import CONTROL_STATS, control_script, finish_job, start_job

torch.set_num_threads(2)
ARCH = "granite-8b"
PATHS = ("float", "xnor", "int8")
MESHES = [(1, 2), (2, 1)]
ENGINE = dict(n_slots=3, max_len=64, chunk_tokens=8)
PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5]]
MAX_TOKENS = [4, 6, 3, 5]
CONTROL_ENGINE = dict(n_slots=2, max_len=64, chunk_tokens=8, page_tokens=8,
                      prefix_cache=True, priorities=True, preempt=True)
# the tiled layers of a reduced granite tick: q, k, v, o, gate, up, down in
# each of its 2 layers, and the head; under (1, 2) each layer also gathers
# its attention output by heads (after v, before o)
TILED_CALLS = 7 * 2 + 1
HEAD_GATHERS = 2
LAYER_OPS = 8


@functools.lru_cache(maxsize=None)
def _export():
    cfg = j_get_config(ARCH).reduced()
    tm = j_build_model(cfg, JModelContext(policy=cfg.tbn, mode=J_TRAIN,
                                          compute_dtype=jnp.float32))
    sm = j_build_model(cfg, _jctx(cfg, "float"))
    sp = j_export(tm.specs(), sm.specs(),
                  j_mod.init_params(tm.specs(), jax.random.PRNGKey(0)), cfg.tbn)
    return cfg, jax.tree.map(np.asarray, sp)


def _jctx(cfg, path):
    return JModelContext(policy=cfg.tbn, mode=J_SERVE, compute_dtype=jnp.float32,
                         use_pallas=False, compute_path=path)


@functools.lru_cache(maxsize=None)
def _jax_engine(path):
    """The JAX engine's greedy (tokens, token steps, finish reasons, ticks)
    on one device."""
    cfg, sp = _export()
    eng = JBatchedEngine(j_build_model(cfg, _jctx(cfg, path)), sp, JServeConfig(
        **ENGINE, prefix_cache=False, telemetry=False, compute_path=path))
    reqs = [eng.submit(p, JSamplingParams(max_tokens=m))
            for p, m in zip(PROMPTS, MAX_TOKENS)]
    ticks = eng.run_until_drained()
    return ([r.output for r in reqs], [r.token_steps for r in reqs],
            [r.finish_reason for r in reqs], ticks)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """(case name, mesh) -> [each rank's result]."""
    sp = _export()[1]
    base = dict(arch=ARCH, dtype="float32", sp=sp)
    cases = {f"warm/{path}": dict(base, kind="warm_engine", meshes=MESHES, path=path,
                                  engine=ENGINE, prompts=PROMPTS,
                                  sampling=[dict(max_tokens=m) for m in MAX_TOKENS])
             for path in PATHS}
    cases["control"] = dict(base, kind="control", meshes=[(1, 2)], warm=True,
                            engine=CONTROL_ENGINE)
    names = list(cases)
    started = start_job(dict(device="cpu", meshes=MESHES,
                             cases=[cases[n] for n in names]),
                        2, tmp_path_factory.mktemp("mesh_warm"))
    for path in PATHS:
        _jax_engine(path)           # while the ranks run
    ranks = finish_job(started)
    return {(n, tuple(d)): [r[(i, tuple(d))] for r in ranks]
            for i, n in enumerate(names) for d in cases[n]["meshes"]}


def _same(per_rank, key):
    first = per_rank[0][key]
    for r in per_rank[1:]:
        if isinstance(first, np.ndarray):
            np.testing.assert_array_equal(r[key], first)
        else:
            assert r[key] == first
    return first


@pytest.mark.parametrize("dims", MESHES)
def test_warmup_records_the_same_collectives_on_every_rank(job, dims):
    for path in PATHS:
        seq = _same(job[(f"warm/{path}", dims)], "sequence")
        assert sorted(seq) == ["decode_tick", "extend_tick"]
        for name, ops in seq.items():
            if dims[1] == 1:
                assert ops == [], (name, ops)
                continue
            assert len(ops) == TILED_CALLS + HEAD_GATHERS, (name, ops)
            assert {(kind, axis, dtype) for kind, axis, _, dtype in ops} == {
                ("all_gather", "model", "torch.float32")}
            cols = 1 if name == "decode_tick" else ENGINE["chunk_tokens"]
            rows = ENGINE["n_slots"] * cols
            heads = [LAYER_OPS * i + 3 for i in range(HEAD_GATHERS)]
            # a rank's (slots, columns, 2 heads x 16) attention output
            assert all(ops[i][2] == (ENGINE["n_slots"], cols, 2 * 16)
                       for i in heads)
            tiled = [op for i, op in enumerate(ops) if i not in heads]
            # every projection gathers the whole batch; the head sees the
            # last column of each slot
            assert all(shape[0] == rows for _, _, shape, _ in tiled[:-1])
            assert tiled[-1][2][0] == ENGINE["n_slots"]


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("dims", MESHES)
def test_warm_meshed_tokens_equal_the_jax_engine(job, dims, path):
    per_rank = job[(f"warm/{path}", dims)]
    got = tuple(_same(per_rank, k) for k in ("tokens", "steps", "finish", "ticks"))
    assert got == _jax_engine(path)
    assert all(f == "length" for f in got[2])
    assert [r["retraces"] for r in per_rank] == [0, 0]


def _single_device_control():
    cfg = get_config(ARCH).reduced()
    sm = build_model(cfg, ModelContext(policy=cfg.tbn, mode=SERVE,
                                       compute_dtype=torch.float32, device="cpu"))
    eng = BatchedEngine(sm, params_from_numpy(_export()[1], "cpu"),
                        ServeConfig(**CONTROL_ENGINE))
    finished = {}
    eng.on_finish = lambda r: finished.setdefault(r.rid, r)
    ticks = control_script(eng)
    reqs = [finished[k] for k in sorted(finished)]
    st = eng.stats()
    return dict(tokens=[r.output for r in reqs], steps=[r.token_steps for r in reqs],
                finish=[r.finish_reason for r in reqs], ticks=ticks,
                stats={k: st[k] for k in CONTROL_STATS}, ptab=eng._ptab.copy(),
                hits=[r.prefix_hit_tokens for r in reqs])


def test_tick_control_keeps_the_ranks_equal(job):
    per_rank = job[("control", (1, 2))]
    want = _single_device_control()
    for key in ("tokens", "steps", "finish", "ticks", "stats", "ptab", "hits"):
        got = _same(per_rank, key)
        if isinstance(got, np.ndarray):
            np.testing.assert_array_equal(got, want[key])
        else:
            assert got == want[key], key
    st = want["stats"]
    assert (st["prefix_hits"], st["preempts"], st["resumes"], st["aborted"]) == (1, 1, 1, 1)
    assert want["finish"].count("aborted") == 1
