"""Heads-sharded attention and K/V pools under a mesh (the reference's
``attn_act`` recipe: q, k and v constrained to their heads over "model",
``act_heads`` / ``act_kv_heads``), on gloo ranks on the CPU, against the
JAX package on one device.

One job of two ``tests/torch_mesh_worker.py`` ranks, started once for the
module, serves under the mesh (1, 2):

* granite-8b ``.reduced()`` (4 heads, 2 K/V heads, f32; the masters of
  ``PRNGKey(0)`` exported by the JAX package): each rank holds pools of
  (..., 1, hd), the rank's K/V head; prefill plus 4 decode steps give the
  JAX model's logits within 1e-4 x max|logit|; under float, xnor and int8
  with int8 K/V (``kv_dtype`` set by ``dataclasses.replace`` on both
  sides) and with bf16 K/V the engine's greedy tokens, finish reasons,
  token steps and ticks equal the JAX engine's, and under int8 K/V each
  rank's codes and scales equal the head slice of the port's single
  engine's;
* warm, the recorded collectives hold one all_gather a layer of the
  attention output by heads before ``wo``, where the same model with
  ``attn_act="seq"`` (time rows split, every head on every rank) gathers
  its packed partial softmaxes instead;
* seamless-m4t-large-v2 ``.reduced()`` holds K/TP heads in its self and
  cross pools and gives the JAX engine's greedy tokens.

In one subprocess, on ``meta`` tensors under a fake process group
(``launch.mesh.ProductionMesh.join``): under (1, 4), where 4 does not
divide the reduced n_kv = 2, granite's pools stay whole (the dividing
rule; its tokens there are ``test_torch_tp_serve.py``'s); a "seq"
architecture (starcoder2-7b ``.reduced()``) keeps every K/V head and half
of each page's rows under (1, 2); granite-8b at full width, 32 slots x
32 768 tokens, holds 154 618 822 656 / 77 309 411 328 / 38 654 705 664 B
of K/V a rank at (1, 1) / (1, 2) / (1, 4) and stays whole at (1, 16); the
dry run counts the gathers of either recipe by kind with their bytes.
Tokens and integers are exact.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
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
from repro_torch.configs import ARCH_IDS, build_model, get_config
from repro_torch.nn.context import SERVE, ModelContext
from repro_torch.serve.engine import BatchedEngine, ServeConfig
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.weights import params_from_numpy
from test_torch_encdec_engine import ENGINE as SEAMLESS_ENGINE
from test_torch_encdec_engine import MAX_TOKENS as SEAMLESS_MAX_TOKENS
from test_torch_encdec_engine import _export as _seamless_export
from test_torch_encdec_engine import _jobs as _seamless_jobs
from test_torch_encdec_engine import _reference as _seamless_reference
from torch_mesh_worker import finish_job, start_job

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
GRANITE, SEAMLESS = "granite-8b", "seamless-m4t-large-v2"
PATHS = ("float", "xnor", "int8")
KV = ("bf16", "int8")
MESH = (1, 2)
PROMPT = [5, 3, 2, 7, 1, 4, 6, 2]
ENGINE = dict(n_slots=3, max_len=64, chunk_tokens=8, page_tokens=8)
PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5]]
MAX_TOKENS = [4, 6, 3, 5]
SEAMLESS_CHUNK = 7
LOGIT_RTOL = 1e-4
LAYERS = 2                       # granite-8b .reduced()


@functools.lru_cache(maxsize=None)
def _export():
    """(JAX reduced granite config, its SERVE params as numpy) from the
    masters of PRNGKey(0), f32."""
    cfg = j_get_config(GRANITE).reduced()
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
def _jax_logits():
    cfg, sp = _export()
    sm = j_build_model(cfg, _jctx(cfg, "float"))
    lg, c, lens = jax.jit(lambda p, b: sm.prefill(p, b, 16))(
        sp, {"tokens": jnp.array([PROMPT], jnp.int32)})
    out = [np.asarray(lg)]
    step = jax.jit(sm.decode_step)
    for _ in range(4):
        tok = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
        lg, c, lens = step(sp, tok, c, lens)
        out.append(np.asarray(lg))
    return out


@functools.lru_cache(maxsize=None)
def _jax_engine(path, kv):
    """The JAX engine's greedy (tokens, token steps, finish reasons, ticks)
    on one device, under ``kv_dtype`` = ``kv``."""
    cfg, sp = _export()
    cfg = dataclasses.replace(cfg, kv_dtype=kv)
    eng = JBatchedEngine(j_build_model(cfg, _jctx(cfg, path)), sp, JServeConfig(
        **ENGINE, prefix_cache=False, telemetry=False, compute_path=path))
    reqs = [eng.submit(p, JSamplingParams(max_tokens=m))
            for p, m in zip(PROMPTS, MAX_TOKENS)]
    ticks = eng.run_until_drained()
    return ([r.output for r in reqs], [r.token_steps for r in reqs],
            [r.finish_reason for r in reqs], ticks)


@functools.lru_cache(maxsize=None)
def _single(path, kv):
    """The port's single engine after the same drain: its (tokens, token
    steps, finish reasons, ticks) and its caches."""
    cfg = dataclasses.replace(get_config(GRANITE).reduced(), kv_dtype=kv)
    sm = build_model(cfg, ModelContext(policy=cfg.tbn, mode=SERVE, device="cpu",
                                       compute_dtype=torch.float32,
                                       compute_path=path))
    eng = BatchedEngine(sm, params_from_numpy(_export()[1], "cpu"),
                        ServeConfig(**ENGINE, compute_path=path))
    reqs = [eng.submit(np.asarray(p, np.int32), SamplingParams(max_tokens=m))
            for p, m in zip(PROMPTS, MAX_TOKENS)]
    ticks = eng.run_until_drained()
    return ([r.output for r in reqs], [r.token_steps for r in reqs],
            [r.finish_reason for r in reqs], ticks), eng.caches


def _granite_case(kind, **kw):
    return dict(kind=kind, arch=GRANITE, dtype="float32", sp=_export()[1],
                meshes=[MESH], **kw)


def _engine_case(path, kv, kind="engine", **cfg):
    return _granite_case(kind, path=path, cfg=dict(cfg, kv_dtype=kv), engine=ENGINE,
                         prompts=PROMPTS, keep_caches=kv == "int8",
                         sampling=[dict(max_tokens=m) for m in MAX_TOKENS])


def _cases():
    cases = {"logits": _granite_case("logits", prompt=PROMPT, max_len=16,
                                     decode_steps=4)}
    for path in PATHS:
        for kv in KV:
            cases[f"engine/{path}/{kv}"] = _engine_case(path, kv)
    for act in ("heads", "seq"):
        cases[f"warm/{act}"] = _engine_case("float", "bf16", kind="warm_engine",
                                            attn_act=act)
    jobs = _seamless_jobs()
    cases["seamless"] = dict(
        kind="engine", arch=SEAMLESS, dtype="float32", meshes=[MESH],
        sp=jax.tree.map(np.asarray, _seamless_export()[1]),
        engine=dict(SEAMLESS_ENGINE, chunk_tokens=SEAMLESS_CHUNK),
        prompts=[p for p, _ in jobs], frames=[f for _, f in jobs],
        sampling=[dict(max_tokens=SEAMLESS_MAX_TOKENS)] * len(jobs))
    return cases


_META_SCRIPT = r"""
import dataclasses, json
import torch
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.distributed.sharding import axis_rules
from repro_torch.launch import cells
from repro_torch.launch.dryrun import count_cell
from repro_torch.launch.mesh import ProductionMesh

def shapes(tree, path=()):
    if isinstance(tree, torch.Tensor):
        return {"/".join(path): list(tree.shape)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(shapes(v, path + (str(k),)))
    return out

out = {}
for arch, dims in (("granite-8b", (1, 2)), ("granite-8b", (1, 4)),
                   ("starcoder2-7b", (1, 2)), ("seamless-m4t-large-v2", (1, 2))):
    cfg = get_config(arch).reduced()
    model = cells._serve_model(cfg)
    mesh = ProductionMesh(dims, ("data", "model")).join()
    kw = {"cross_pages": 4} if cfg.family == "encdec" else {}
    with axis_rules(mesh):
        caches = model.init_caches(3, 64, torch.bfloat16, page_tokens=8,
                                   n_pages=24, **kw)
    out["pools %s %dx%d" % ((arch,) + dims)] = shapes(caches)
g = get_config("granite-8b")
for dims in ((1, 1), (1, 2), (1, 4), (1, 16)):
    mesh = ProductionMesh(dims, ("data", "model")).join()
    plan = cells.build_decode_cell(g, ShapeCell("kv", 32768, 32, "decode"), mesh)
    out["kv %dx%d" % dims] = plan["memory"]["cache_bytes"]
small = get_config("granite-8b").reduced()
for act in ("heads", "seq"):
    r = count_cell(dataclasses.replace(small, attn_act=act),
                   ShapeCell("d", 64, 3, "decode"), (1, 2), page_tokens=8)
    out["count " + act] = {k: r[k] for k in ("coll_calls", "coll_bytes", "cache_bytes")}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """(case name) -> [each rank's result], and the meta subprocess's
    counts; the ranks, the subprocess and the JAX references run at once."""
    cases = _cases()
    names = list(cases)
    started = start_job(dict(device="cpu", meshes=[MESH],
                             cases=[cases[n] for n in names]),
                        2, tmp_path_factory.mktemp("heads_shard"))
    meta = subprocess.Popen([sys.executable, "-c", _META_SCRIPT], cwd=ROOT,
                            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    _jax_logits()
    for path in PATHS:
        for kv in KV:
            _jax_engine(path, kv)
    _seamless_reference("float", SEAMLESS_CHUNK)
    ranks = finish_job(started)
    out, err = meta.communicate(timeout=300)
    assert meta.returncode == 0, err[-3000:]
    got = {n: [r[(i, MESH)] for r in ranks] for i, n in enumerate(names)}
    return got, json.loads(out.strip().splitlines()[-1])


def _same(per_rank, key):
    first = per_rank[0][key]
    for r in per_rank[1:]:
        if isinstance(first, list) and first and isinstance(first[0], torch.Tensor):
            assert all(torch.equal(a, b) for a, b in zip(r[key], first, strict=True))
        else:
            assert r[key] == first
    return first


def _kv_heads(shapes):
    """{leaf path: its K/V head count} of the pools' k / v / ks / vs."""
    out = {}
    for path, shape in shapes.items():
        leaf = path.split("/")[-1]
        if leaf in ("k", "v"):
            out[path] = shape[-2]
        elif leaf in ("ks", "vs"):
            out[path] = shape[-1]
    return out


@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_attn_act_equals_reference(arch):
    assert sorted(ARCH_IDS) == sorted(J_ARCH_IDS)
    assert get_config(arch).attn_act == j_get_config(arch).attn_act


def test_granite_logits_on_a_head_block(job):
    per_rank = job[0]["logits"]
    got, want = _same(per_rank, "logits"), _jax_logits()
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=LOGIT_RTOL * float(np.abs(w).max()))
        assert (g.argmax(-1).numpy() == w.argmax(-1)).all()
    for r in per_rank:
        heads = _kv_heads(r["cache_shapes"])
        assert heads and set(heads.values()) == {1}, heads


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("path", PATHS)
def test_meshed_engine_on_head_blocks_equals_the_jax_engine(job, path, kv):
    per_rank = job[0][f"engine/{path}/{kv}"]
    got = tuple(_same(per_rank, k) for k in ("tokens", "steps", "finish", "ticks"))
    assert got == _jax_engine(path, kv)
    for r in per_rank:
        shapes = r["cache_shapes"]
        heads = _kv_heads(shapes)
        assert set(heads.values()) == {1}, heads
        names = {p.split("/")[-1] for p in heads}
        assert names == ({"k", "v"} if kv == "bf16" else {"k", "v", "ks", "vs"})
        # (layers, pages + scratch, page tokens, 1 of 2 heads, hd)
        assert shapes["0/k"] == (LAYERS, 3 * 8 + 1, 8, 1, 16)


@pytest.mark.parametrize("path", PATHS)
def test_int8_codes_and_scales_are_the_single_engines_head_slice(job, path):
    """Exact on every path: a rank's B1 / B2 (their plain versions here)
    sum each element of its r/TP tile rows as the whole call does."""
    one = _single(path, "int8")[1][0]
    for rank, r in enumerate(job[0][f"engine/{path}/int8"]):
        held = r["caches"][0]
        for name in ("k", "v", "ks", "vs"):
            codes = name in ("k", "v")
            want = one[name].narrow(held[name].ndim - (2 if codes else 1), rank, 1)
            assert held[name].dtype == (torch.int8 if codes else torch.float32)
            assert torch.equal(held[name], want), name


def test_warm_ticks_gather_each_layers_attention_by_heads(job):
    heads, seq = (job[0][f"warm/{act}"] for act in ("heads", "seq"))
    cold = job[0]["engine/float/bf16"]
    for key in ("tokens", "steps", "finish", "ticks"):
        assert _same(heads, key) == _same(cold, key)
    assert _same(seq, "tokens") == _same(heads, "tokens")
    h_seq, s_seq = _same(heads, "sequence"), _same(seq, "sequence")
    assert sorted(h_seq) == ["decode_tick", "extend_tick"]
    for name, ops in h_seq.items():
        base = s_seq[name]
        assert len(ops) == len(base), name
        cols = 1 if name == "decode_tick" else ENGINE["chunk_tokens"]
        # each layer's (slots, columns, 2 heads x 16) output, over "model";
        # under "seq" each layer's packed partials (1, slots, columns, 2 K/V
        # heads, 2 groups, 16 + 2; f64) instead, in the same place
        by_heads = ("all_gather", "model", (ENGINE["n_slots"], cols, 32),
                    "torch.float32")
        partials = ("all_gather", "model", (1, ENGINE["n_slots"], cols, 2, 2, 18),
                    "torch.float64")
        added = [i for i, op in enumerate(ops) if op == by_heads]
        # after the layer's q, k, v and before its wo
        assert added == [3, 11]
        assert [i for i, op in enumerate(base) if op == partials] == added
        assert [op for i, op in enumerate(ops) if i not in added] == [
            op for i, op in enumerate(base) if i not in added]
    for r in heads + seq:
        assert r["retraces"] == 0
    assert set(_kv_heads(seq[0]["cache_shapes"]).values()) == {2}
    # the seq engine's pools hold half of each page's 8 rows
    assert seq[0]["cache_shapes"]["0/k"] == (LAYERS, 3 * 8 + 1, 4, 2, 16)


def test_seamless_self_and_cross_pools_on_a_head_block(job):
    per_rank = job[0]["seamless"]
    got = tuple(_same(per_rank, k) for k in ("tokens", "finish", "steps", "ticks"))
    assert got == _seamless_reference("float", SEAMLESS_CHUNK)[0]
    for r in per_rank:
        heads = _kv_heads(r["cache_shapes"])
        assert sorted(heads) == ["cross/k", "cross/v", "self/k", "self/v"]
        assert set(heads.values()) == {1}


def test_pools_stay_whole_where_the_rule_does_not_divide(job):
    meta = job[1]
    assert set(_kv_heads(meta["pools granite-8b 1x2"]).values()) == {1}
    assert set(_kv_heads(meta["pools granite-8b 1x4"]).values()) == {2}
    # a "seq" architecture keeps every K/V head and half of each page's rows
    star = meta["pools starcoder2-7b 1x2"]
    assert set(_kv_heads(star).values()) == {2}
    assert star["0/k"] == [2, 25, 4, 2, 16]
    seam = _kv_heads(meta["pools seamless-m4t-large-v2 1x2"])
    assert len(seam) == 4 and set(seam.values()) == {1}


def test_full_width_kv_bytes_a_rank(job):
    meta = job[1]
    whole = 36 * 32 * 32_768 * 8 * 128 * 2 * 2          # L, slots, T, K, hd, k+v, bf16
    assert whole == 154_618_822_656
    assert [meta[f"kv 1x{tp}"] for tp in (1, 2, 4, 16)] == [
        whole, 77_309_411_328, 38_654_705_664, whole]


def test_dry_run_counts_the_head_gathers_by_kind_and_bytes(job):
    heads, seq = job[1]["count heads"], job[1]["count seq"]
    # 15 tile gathers (7 a layer and the head) and one gather a layer: of
    # the attention output by heads, or under "seq" of the partials
    assert seq["coll_calls"] == heads["coll_calls"] == {"all-gather": 15 + LAYERS}
    # by heads, the (3 slots, 1 column, 4 heads x 16) bf16 output; under
    # "seq" the f64 partials of 2 ranks, (2, 3, 1, 2 K, 2 groups, 16 + 2)
    added = seq["coll_bytes"]["all-gather"] - heads["coll_bytes"]["all-gather"]
    assert added == LAYERS * (2 * 3 * 1 * 2 * 2 * 18 * 8 - 3 * 1 * 4 * 16 * 2)
    # the pool: 2 layers x 25 pages x 8 tokens x K x 16 x (k, v) x 2 B,
    # halved by heads or by time rows
    assert 2 * seq["cache_bytes"] == 2 * heads["cache_bytes"] == 2 * 25 * 8 * 2 * 16 * 2 * 2
