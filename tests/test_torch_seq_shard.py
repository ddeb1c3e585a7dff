"""Sequence-sharded attention and K/V caches under a mesh (the reference's
"seq" recipe: q, k and v sequence-sharded over "model", every cache's time
axis over "model"), on gloo ranks on the CPU, against the JAX package on
one device.

One job of two ``tests/torch_mesh_worker.py`` ranks, started once for the
module, serves under the mesh (1, 2). Position p lives on the rank of
index p mod 2; each rank attends its own rows and the ranks merge their
partial softmaxes (``distributed.sharding.merge_partials``):

* starcoder2-7b ``.reduced()`` (f32, the masters of ``PRNGKey(0)``
  exported by the JAX package): prefill plus 4 decode steps give the JAX
  model's logits within 1e-4 x max|logit|, each rank holding 8 of the 16
  dense rows; under float, xnor and int8, with bf16 and with int8 K/V, the
  engine's greedy tokens, token steps, finish reasons and ticks equal the
  JAX engine's; each rank's pool (codes and scales) holds 4 of each
  page's 8 rows, those of positions = its index (mod 2), equal on every
  layer, bit for bit on every path, to the rows of a single engine that
  attends in the mesh's arithmetic (one part);
* qwen1.5-32b ``.reduced()`` on its int8 K/V: the same logits and tokens;
* recurrentgemma-2b ``.reduced()`` (window 8): each rank holds 4 of the
  ring's 8 rows and the engine's tokens equal the JAX engine's;
* a prefix hit and a preempt-and-resume (``control_script``) give the
  single engine's tokens, stats and page tables;
* warm, a tick records one gather a layer of the packed partials.

A CPU unit test holds the merge to the whole softmax, with a part that
has no valid key and a row that has none anywhere. A ``meta`` subprocess
(``launch.mesh.ProductionMesh.join``) counts starcoder2-7b's decode_32k
K/V a rank, 274 877 906 944 B / TP at (1, 2), (1, 4) and (1, 16), and
keeps a pool whole where the model axis divides no page.
"""
import concurrent.futures
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

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
from repro_torch.distributed.sharding import SeqBlock, merge_partials, merge_softmax_parts
from repro_torch.nn.attention import _attend_core, _partial_core
from repro_torch.nn.context import SERVE, ModelContext
from repro_torch.serve.engine import BatchedEngine, ServeConfig
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.weights import params_from_numpy
from torch_mesh_worker import (
    CONTROL_STATS,
    control_script,
    finish_job,
    one_part_seq,
    start_job,
)

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
STARCODER, QWEN, RGEMMA = "starcoder2-7b", "qwen1.5-32b", "recurrentgemma-2b"
PATHS = ("float", "xnor", "int8")
KV = ("bf16", "int8")
MESH = (1, 2)
TP = MESH[1]
PROMPT = [5, 3, 2, 7, 1, 4, 6, 2, 9, 9, 1]
ENGINE = dict(n_slots=3, max_len=64, chunk_tokens=8, page_tokens=8)
PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5]]
MAX_TOKENS = [4, 6, 3, 5]
CONTROL_ENGINE = dict(n_slots=2, max_len=64, chunk_tokens=8, page_tokens=8,
                      prefix_cache=True, priorities=True, preempt=True)
LOGIT_RTOL = 1e-4
LAYERS = 2                       # starcoder2-7b / qwen1.5-32b .reduced()


@functools.lru_cache(maxsize=None)
def _export(arch):
    """(JAX reduced config, its SERVE params as numpy) from the masters of
    PRNGKey(0), f32."""
    cfg = j_get_config(arch).reduced()
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
def _jax_logits(arch):
    cfg, sp = _export(arch)
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
def _jax_engine(arch, path, kv):
    """The JAX engine's greedy (tokens, token steps, finish reasons, ticks)
    on one device, under ``kv_dtype`` = ``kv``."""
    cfg, sp = _export(arch)
    cfg = dataclasses.replace(cfg, kv_dtype=kv)
    eng = JBatchedEngine(j_build_model(cfg, _jctx(cfg, path)), sp, JServeConfig(
        **ENGINE, prefix_cache=False, telemetry=False, compute_path=path))
    reqs = [eng.submit(p, JSamplingParams(max_tokens=m))
            for p, m in zip(PROMPTS, MAX_TOKENS)]
    ticks = eng.run_until_drained()
    return ([r.output for r in reqs], [r.token_steps for r in reqs],
            [r.finish_reason for r in reqs], ticks)


def _single_model(arch, path, kv=None):
    cfg = get_config(arch).reduced()
    if kv is not None:
        cfg = dataclasses.replace(cfg, kv_dtype=kv)
    return build_model(cfg, ModelContext(policy=cfg.tbn, mode=SERVE, device="cpu",
                                         compute_dtype=torch.float32,
                                         compute_path=path))


@functools.lru_cache(maxsize=None)
def _single_caches(path, kv):
    """The port's single starcoder2 engine's caches after the greedy drain,
    its "seq" layers attending as the mesh's one part (``one_part_seq``)."""
    with one_part_seq():
        eng = BatchedEngine(_single_model(STARCODER, path, kv),
                            params_from_numpy(_export(STARCODER)[1], "cpu"),
                            ServeConfig(**ENGINE, compute_path=path))
        for p, m in zip(PROMPTS, MAX_TOKENS):
            eng.submit(np.asarray(p, np.int32), SamplingParams(max_tokens=m))
        eng.run_until_drained()
    return eng.caches


def _case(kind, arch, **kw):
    return dict(kind=kind, arch=arch, dtype="float32", sp=_export(arch)[1],
                meshes=[MESH], **kw)


def _engine_case(arch, path, kv=None, kind="engine", **kw):
    cfg = {} if kv is None else dict(kv_dtype=kv)
    return _case(kind, arch, path=path, cfg=cfg, engine=ENGINE, prompts=PROMPTS,
                 sampling=[dict(max_tokens=m) for m in MAX_TOKENS], **kw)


def _cases():
    cases = {f"logits/{a}": _case("logits", a, prompt=PROMPT, max_len=16,
                                  decode_steps=4) for a in (STARCODER, QWEN)}
    for path in PATHS:
        for kv in KV:
            cases[f"engine/{STARCODER}/{path}/{kv}"] = _engine_case(
                STARCODER, path, kv, keep_caches=True)
        cases[f"engine/{QWEN}/{path}"] = _engine_case(QWEN, path)
    cases[f"engine/{RGEMMA}"] = _engine_case(RGEMMA, "float")
    cases["warm"] = _engine_case(STARCODER, "float", "bf16", kind="warm_engine")
    cases["control"] = _case("control", STARCODER, warm=True, engine=CONTROL_ENGINE)
    return cases


_META_SCRIPT = r"""
import json
import torch
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.distributed.sharding import axis_rules
from repro_torch.launch import cells
from repro_torch.launch.mesh import ProductionMesh

out = {}
cfg = get_config("starcoder2-7b")
for tp in (2, 4, 16):
    mesh = ProductionMesh((1, tp), ("data", "model")).join()
    plan = cells.build_decode_cell(cfg, SHAPES["decode_32k"], mesh)
    out["kv 1x%d" % tp] = plan["memory"]["cache_bytes"]
    out["rows 1x%d" % tp] = plan["memory"]["cache_time_rows"]
small = cells._serve_model(get_config("starcoder2-7b").reduced())
for tp in (2, 16):
    mesh = ProductionMesh((1, tp), ("data", "model")).join()
    with axis_rules(mesh):
        caches = small.init_caches(3, 64, torch.bfloat16, page_tokens=8, n_pages=24)
    out["pool 1x%d" % tp] = list(caches[0]["k"].shape)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """(case name) -> [each rank's result], and the meta subprocess's
    counts; the ranks, the subprocess and the references run at once."""
    cases = _cases()
    names = list(cases)
    started = start_job(dict(device="cpu", meshes=[MESH],
                             cases=[cases[n] for n in names]),
                        2, tmp_path_factory.mktemp("seq_shard"))
    meta = subprocess.Popen([sys.executable, "-c", _META_SCRIPT], cwd=ROOT,
                            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    # the port's single engines on a thread beside the JAX references
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        singles = [pool.submit(_single_caches, path, kv) for path in PATHS for kv in KV]
        for arch in (STARCODER, QWEN):
            _jax_logits(arch)
        for path in PATHS:
            for kv in KV:
                _jax_engine(STARCODER, path, kv)
            _jax_engine(QWEN, path, "int8")
        _jax_engine(RGEMMA, "float", "bf16")
        for f in singles:
            f.result()
    ranks = finish_job(started)
    out, err = meta.communicate(timeout=300)
    assert meta.returncode == 0, err[-3000:]
    got = {n: [r[(i, MESH)] for r in ranks] for i, n in enumerate(names)}
    return got, json.loads(out.strip().splitlines()[-1])


def _same(per_rank, key):
    first = per_rank[0][key]
    for r in per_rank[1:]:
        if isinstance(first, np.ndarray):
            np.testing.assert_array_equal(r[key], first)
        elif isinstance(first, list) and first and isinstance(first[0], torch.Tensor):
            assert all(torch.equal(a, b) for a, b in zip(r[key], first, strict=True))
        else:
            assert r[key] == first
    return first


def _time_rows(shapes):
    """{leaf path: its time rows} of the attention caches' k / v / ks / vs
    (the axis after pages, slots or layers)."""
    out = {}
    for path, shape in shapes.items():
        leaf = path.split("/")[-1]
        if leaf in ("k", "v"):
            out[path] = shape[-3]
        elif leaf in ("ks", "vs"):
            out[path] = shape[-2]
    return out


@pytest.mark.parametrize("arch", [STARCODER, QWEN])
def test_logits_on_time_shards(job, arch):
    per_rank = job[0][f"logits/{arch}"]
    got, want = _same(per_rank, "logits"), _jax_logits(arch)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=LOGIT_RTOL * float(np.abs(w).max()))
        assert (g.argmax(-1).numpy() == w.argmax(-1)).all()
    for r in per_rank:
        rows = _time_rows(r["cache_shapes"])
        # the dense cache's 16 rows, half a rank
        assert rows and set(rows.values()) == {16 // TP}, rows
        assert len(rows) == (4 if arch == QWEN else 2)


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("path", PATHS)
def test_starcoder2_engine_on_time_shards_equals_the_jax_engine(job, path, kv):
    per_rank = job[0][f"engine/{STARCODER}/{path}/{kv}"]
    got = tuple(_same(per_rank, k) for k in ("tokens", "steps", "finish", "ticks"))
    assert got == _jax_engine(STARCODER, path, kv)
    for r in per_rank:
        shapes = r["cache_shapes"]
        assert set(_time_rows(shapes).values()) == {ENGINE["page_tokens"] // TP}
        # (layers, pages + scratch, 8 / 2 page rows, both K/V heads, hd)
        assert shapes["0/k"] == (LAYERS, 3 * 8 + 1, 4, 2, 16)


@pytest.mark.parametrize("path", PATHS)
def test_qwen_engine_on_int8_time_shards_equals_the_jax_engine(job, path):
    per_rank = job[0][f"engine/{QWEN}/{path}"]
    got = tuple(_same(per_rank, k) for k in ("tokens", "steps", "finish", "ticks"))
    assert got == _jax_engine(QWEN, path, "int8")
    for r in per_rank:
        shapes = r["cache_shapes"]
        assert sorted(_time_rows(shapes)) == ["0/k", "0/ks", "0/v", "0/vs"]
        assert shapes["0/k"] == (LAYERS, 3 * 8 + 1, 4, 2, 16)
        assert shapes["0/ks"] == (LAYERS, 3 * 8 + 1, 4, 2)


def test_recurrentgemma_ring_on_time_shards_equals_the_jax_engine(job):
    per_rank = job[0][f"engine/{RGEMMA}"]
    got = tuple(_same(per_rank, k) for k in ("tokens", "steps", "finish", "ticks"))
    assert got == _jax_engine(RGEMMA, "float", "bf16")
    window = get_config(RGEMMA).reduced().window
    for r in per_rank:
        shapes = r["cache_shapes"]
        # the attention layer's ring: 3 slots x window / 2 rows; the
        # recurrent carries stay whole
        assert shapes["0/b2/k"] == (1, ENGINE["n_slots"], window // TP, 1, 16)
        assert shapes["0/b0/h"] == (1, ENGINE["n_slots"], 64)


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("path", PATHS)
def test_rank_rows_are_the_single_engines_rows_of_its_residue(job, path, kv):
    """Rank rho holds, of every page, the rows of the positions = rho (mod
    2). The single engine attends as the mesh's one part (f64 partials,
    rounded once), and a rank's B1 / B2 (their plain versions here) sum
    each element of its block as the whole call does, so every layer's
    rows equal its bit for bit on every path. The scratch page, never
    read, is not compared."""
    one = _single_caches(path, kv)[0]
    for rank, r in enumerate(job[0][f"engine/{STARCODER}/{path}/{kv}"]):
        held = r["caches"][0]
        assert sorted(held) == (["k", "v"] if kv == "bf16" else ["k", "ks", "v", "vs"])
        for name, got in held.items():
            want = one[name].unflatten(2, (-1, TP)).select(3, rank)
            assert got.dtype == want.dtype and got.shape == want.shape, name
            for layer in range(LAYERS):
                # the last page is scratch: dropped writes land there
                assert torch.equal(got[layer, :-1], want[layer, :-1]), (name, layer)


def test_warm_ticks_gather_the_partials_once_a_layer(job):
    per_rank = job[0]["warm"]
    cold = job[0][f"engine/{STARCODER}/float/bf16"]
    for key in ("tokens", "steps", "finish", "ticks"):
        assert _same(per_rank, key) == _same(cold, key)
    seq = _same(per_rank, "sequence")
    assert sorted(seq) == ["decode_tick", "extend_tick"]
    for name, ops in seq.items():
        cols = 1 if name == "decode_tick" else ENGINE["chunk_tokens"]
        # (1, slots, columns, K, groups, hd + 2) f64: o, m and l packed
        partial = ("all_gather", "model", (1, ENGINE["n_slots"], cols, 2, 2, 18),
                   "torch.float64")
        # after q, k, v and before wo (a layer: q, k, v, o, up, down)
        assert [i for i, op in enumerate(ops) if op == partial] == [3, 10], ops
        assert all(len(op[2]) == 2 for op in ops if op != partial)
    for r in per_rank:
        assert r["retraces"] == 0


def _single_device_control():
    eng = BatchedEngine(_single_model(STARCODER, "float"),
                        params_from_numpy(_export(STARCODER)[1], "cpu"),
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


def test_prefix_hit_and_preempt_resume_on_time_shards(job):
    per_rank = job[0]["control"]
    want = _single_device_control()
    for key in ("tokens", "steps", "finish", "ticks", "stats", "ptab", "hits"):
        got = _same(per_rank, key)
        if isinstance(got, np.ndarray):
            np.testing.assert_array_equal(got, want[key])
        else:
            assert got == want[key], key
    st = want["stats"]
    assert (st["prefix_hits"], st["preempts"], st["resumes"], st["aborted"]) == (1, 1, 1, 1)


@pytest.mark.parametrize("empty", ["none", "one part", "every part"])
def test_merge_of_partial_softmaxes_equals_the_whole(empty):
    """Keys split by position mod 2 (the ranks' rows); each part's f64
    partial softmax merged equals the whole attend (f32, the reference's
    arithmetic). A part with no valid key for a
    row weighs nothing (its masked scores are NEG_INF, not -inf); a row
    with no valid key anywhere gives 0, finite."""
    gen = torch.Generator().manual_seed(3)
    q = torch.randn((2, 3, 2, 2, 16), generator=gen)
    k = torch.randn((2, 12, 2, 16), generator=gen)
    v = torch.randn((2, 12, 2, 16), generator=gen)
    mask = torch.rand((2, 3, 12), generator=gen) < 0.6
    mask[:, :, 0] = True
    if empty == "one part":
        mask[:, 1, 1::2] = False
    elif empty == "every part":
        mask[:, 2] = False
    scale = 1 / math.sqrt(16)
    parts = []
    for rank in range(2):
        o, m, l = _partial_core(q, k[:, rank::2], v[:, rank::2], mask[..., rank::2],
                                scale)
        parts.append(torch.cat([o, m[..., None], l[..., None]], -1))
    got = merge_softmax_parts(torch.stack(parts))
    assert got.dtype == torch.float64 and torch.isfinite(got).all()
    got = got.float()
    live = mask.any(-1)
    want = _attend_core(q, k, v, mask, scale)
    torch.testing.assert_close(got[live], want[live], rtol=1e-5, atol=1e-6)
    assert (got[~live] == 0).all()
    assert bool((~live).any()) == (empty == "every part")


def test_one_part_merge_is_the_merged_part():
    """A ``SeqBlock`` over no axes merges its one part without a gather:
    ``merge_softmax_parts`` of that part, the whole attend; a row with no
    valid key gives 0."""
    gen = torch.Generator().manual_seed(5)
    q = torch.randn((2, 3, 2, 2, 16), generator=gen)
    k = torch.randn((2, 10, 2, 16), generator=gen)
    v = torch.randn((2, 10, 2, 16), generator=gen)
    mask = torch.rand((2, 3, 10), generator=gen) < 0.5
    mask[:, 0] = True
    mask[1, 2] = False
    o, m, l = _partial_core(q, k, v, mask, 0.25)
    got = merge_partials(o, m, l, SeqBlock(None, (), 1, 0))
    packed = torch.cat([o, m[..., None], l[..., None]], -1)[None]
    torch.testing.assert_close(got, merge_softmax_parts(packed), rtol=0, atol=0)
    live = mask.any(-1)
    torch.testing.assert_close(got.float()[live], _attend_core(q, k, v, mask, 0.25)[live],
                               rtol=1e-5, atol=1e-6)
    assert (got[~live] == 0).all()


def test_kv_bytes_a_rank_at_production_widths(job):
    meta = job[1]
    whole = 32 * 128 * 32_768 * 4 * 128 * 2 * 2     # L, slots, T, K, hd, k+v, bf16
    assert whole == 274_877_906_944
    assert [meta[f"kv 1x{tp}"] for tp in (2, 4, 16)] == [whole // tp for tp in (2, 4, 16)]
    assert meta["kv 1x16"] == 17_179_869_184
    # the dense cache's 32768 / TP rows a rank, k and v
    assert [meta[f"rows 1x{tp}"] for tp in (2, 4, 16)] == [
        {"0/k": rows, "0/v": rows} for rows in (16_384, 8_192, 2_048)]


def test_a_pool_the_model_axis_does_not_divide_stays_whole(job):
    meta = job[1]
    assert meta["pool 1x2"] == [2, 25, 4, 2, 16]
    # 16 divides no page of 8 rows: every row on every rank
    assert meta["pool 1x16"] == [2, 25, 8, 2, 16]
