"""Slots over "data" (the reference's ``act_batch`` rule: activation rows
over ("pod", "data")), on gloo ranks on the CPU, against the JAX package's
engine on one device and the port's single engine.

Two jobs of ``tests/torch_mesh_worker.py`` ranks, started once for the
module, serve 4-slot engines under (2, 1) (two ranks) and (2, 2) (four):
data rank d runs and holds slots [2 d, 2 d + 2):

* granite-8b under float, xnor and int8, starcoder2-7b on float,
  qwen1.5-32b on its int8 K/V under xnor, qwen2-moe under int8, mamba2
  on float and recurrentgemma-2b under xnor (``.reduced()``, f32, the
  masters of ``PRNGKey(0)`` exported by the JAX package) give the JAX
  engine's greedy tokens, token steps, finish reasons and ticks on every
  rank at (2, 1), and granite-8b ("heads" beside the data split),
  qwen1.5-32b ("seq") and mamba2 at (2, 2);
* a rank's per-slot caches hold its 2 slots: recurrentgemma's carries
  and window rings are the single engine's rows of those slots bit for
  bit (mamba2's carries to 1e-6: the host's vectorized softplus rounds by
  an element's place in its loop), and under (2, 1) a rank's paged pool
  (whole on every rank) is the single engine's pool bit for bit (a rank's
  B1 / B2, their plain versions here, sum its rows as the whole batch
  does);
* a prefix hit and a preempt-and-resume (``control_script`` on 2 slots,
  one a data rank): the hit reads pages written by the other data block
  and the parked request resumes on the other data rank, whose carries
  (mamba2) come from the snapshot the first took, with the single
  engine's tokens, stats and page tables;
* warm at (2, 2), a tick records one gather over "data" a layer (the new
  K/V rows before the pool write) and none in a tiled layer, whose unique
  rows are gathered over "model" alone.

A ``meta`` subprocess (``launch.mesh.ProductionMesh.join``) counts
qwen1.5-32b's decode_32k K/V a rank on both production meshes: 128 slots
over 16 (32) data ranks and 2048 of 32 768 time rows over 16 model ranks,
11 072 962 560 B at (16, 16) and 5 536 481 280 B at (2, 16, 16).
"""
import concurrent.futures
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
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.weights import params_from_numpy
from torch_mesh_worker import CONTROL_STATS, control_script, finish_job, start_job

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
GRANITE, STARCODER, QWEN = "granite-8b", "starcoder2-7b", "qwen1.5-32b"
MOE, MAMBA, RGEMMA = "qwen2-moe-a2.7b", "mamba2-370m", "recurrentgemma-2b"
DP = 2
ENGINE = dict(n_slots=4, max_len=64, chunk_tokens=8, page_tokens=8)
PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5],
           [2, 7, 1, 8]]
MAX_TOKENS = [4, 6, 3, 5, 4]
CONTROL_ENGINE = dict(n_slots=2, max_len=64, chunk_tokens=8, page_tokens=8,
                      prefix_cache=True, priorities=True, preempt=True)
# (arch, compute path, kept caches compared with the single engine)
ENGINES = [(GRANITE, "float", True), (GRANITE, "xnor", False),
           (GRANITE, "int8", False), (STARCODER, "float", True),
           (QWEN, "xnor", False), (MOE, "int8", False), (MAMBA, "float", True),
           (RGEMMA, "xnor", True)]
CONTROLS = (GRANITE, MAMBA)
# the (arch, path) engines also served at (2, 2): one of each attention
# recipe beside the data split ("heads", "seq" on the int8 pool) and the
# SSM carries
MESH_22 = ((GRANITE, "float"), (QWEN, "xnor"), (MAMBA, "float"))


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
def _jax_engine(arch, path):
    """The JAX engine's greedy (tokens, token steps, finish reasons, ticks)
    on one device."""
    cfg, sp = _export(arch)
    eng = JBatchedEngine(j_build_model(cfg, _jctx(cfg, path)), sp, JServeConfig(
        **ENGINE, prefix_cache=False, telemetry=False, compute_path=path))
    reqs = [eng.submit(p, JSamplingParams(max_tokens=m))
            for p, m in zip(PROMPTS, MAX_TOKENS)]
    ticks = eng.run_until_drained()
    return ([r.output for r in reqs], [r.token_steps for r in reqs],
            [r.finish_reason for r in reqs], ticks)


def _single_model(arch, path="float"):
    cfg = get_config(arch).reduced()
    return build_model(cfg, ModelContext(policy=cfg.tbn, mode=SERVE, device="cpu",
                                         compute_dtype=torch.float32,
                                         compute_path=path))


@functools.lru_cache(maxsize=None)
def _single_caches(arch, path):
    """The port's single engine's caches after the greedy drain."""
    eng = BatchedEngine(_single_model(arch, path),
                        params_from_numpy(_export(arch)[1], "cpu"),
                        ServeConfig(**ENGINE, compute_path=path))
    for p, m in zip(PROMPTS, MAX_TOKENS):
        eng.submit(np.asarray(p, np.int32), SamplingParams(max_tokens=m))
    eng.run_until_drained()
    return eng.caches


@functools.lru_cache(maxsize=None)
def _single_control(arch):
    eng = BatchedEngine(_single_model(arch), params_from_numpy(_export(arch)[1], "cpu"),
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


def _case(kind, arch, meshes, **kw):
    return dict(kind=kind, arch=arch, dtype="float32", sp=_export(arch)[1],
                meshes=meshes, **kw)


def _engine_case(arch, path, meshes, kind="engine", **kw):
    return _case(kind, arch, meshes, path=path, engine=ENGINE, prompts=PROMPTS,
                 sampling=[dict(max_tokens=m) for m in MAX_TOKENS], **kw)


def _cases(mesh):
    """The cases of the job of ``mesh``: every engine and control at (2, 1);
    at (2, 2) (four ranks on one CPU) the engines of MESH_22 and one
    control."""
    engines = ENGINES if mesh == (2, 1) else [e for e in ENGINES if e[:2] in MESH_22]
    cases = {f"engine/{a}/{p}": _engine_case(a, p, [mesh], keep_caches=keep)
             for a, p, keep in engines}
    for arch in CONTROLS if mesh == (2, 1) else CONTROLS[:1]:
        cases[f"control/{arch}"] = _case("control", arch, [mesh], engine=CONTROL_ENGINE)
    if mesh == (2, 2):
        cases["warm"] = _engine_case(GRANITE, "float", [mesh], kind="warm_engine")
    return cases


_META_SCRIPT = r"""
import json
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.launch import cells
from repro_torch.launch.mesh import make_production_mesh

out = {}
cfg = get_config("qwen1.5-32b")
for multi in (False, True):
    prod = make_production_mesh(multi_pod=multi)
    plan = cells.build_decode_cell(cfg, SHAPES["decode_32k"], prod.join())
    out["x".join(map(str, prod.shape))] = [plan["memory"]["cache_bytes"],
                                           plan["memory"]["cache_time_rows"]["0/k"],
                                           int(plan["args"][2][0]["k"].shape[1])]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """(name, mesh) -> [each rank's result], and the meta subprocess's
    counts; the two jobs, the subprocess and the references run at once."""
    started = []
    for world, meshes in ((2, [(2, 1)]), (4, [(2, 2)])):
        cases = _cases(meshes[0])
        names = list(cases)
        started.append((names, cases, start_job(
            dict(device="cpu", meshes=meshes, cases=[cases[n] for n in names]),
            world, tmp_path_factory.mktemp(f"data{world}"))))
    meta = subprocess.Popen([sys.executable, "-c", _META_SCRIPT], cwd=ROOT,
                            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        singles = [pool.submit(_single_caches, a, p) for a, p, keep in ENGINES if keep]
        singles += [pool.submit(_single_control, a) for a in CONTROLS]
        for arch, path, _ in ENGINES:
            _jax_engine(arch, path)
        for f in singles:
            f.result()
    got = {}
    for names, cases, handle in started:
        ranks = finish_job(handle)
        for i, name in enumerate(names):
            for dims in cases[name]["meshes"]:
                got[(name, tuple(dims))] = [r[(i, tuple(dims))] for r in ranks]
    out, err = meta.communicate(timeout=300)
    assert meta.returncode == 0, err[-3000:]
    return got, json.loads(out.strip().splitlines()[-1])


def _same(per_rank, key):
    first = per_rank[0][key]
    for r in per_rank[1:]:
        if isinstance(first, np.ndarray):
            np.testing.assert_array_equal(r[key], first)
        else:
            assert r[key] == first
    return first


def _data_index(rank: int, mesh) -> int:
    """The data index of ``rank`` in a (data, model) mesh, model innermost."""
    return rank // mesh[1]


def _walk(tree, path=()):
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    else:
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))


@pytest.mark.parametrize("arch,path,mesh", [(a, p, (2, 1)) for a, p, _ in ENGINES]
                         + [(a, p, (2, 2)) for a, p in MESH_22])
def test_engine_tokens_equal_the_jax_engine(job, arch, path, mesh):
    per_rank = job[0][(f"engine/{arch}/{path}", mesh)]
    got = tuple(_same(per_rank, k) for k in ("tokens", "steps", "finish", "ticks"))
    assert got == _jax_engine(arch, path)


def _slot_axis(path, single, held):
    """The slot axis of a per-slot leaf (its one dim that halves), or None
    for a pool leaf (held whole)."""
    axes = [i for i, (a, b) in enumerate(zip(single.shape, held.shape)) if a != b]
    if not axes:
        return None
    assert len(axes) == 1 and single.shape[axes[0]] == DP * held.shape[axes[0]], path
    return axes[0]


@pytest.mark.parametrize("arch", [MAMBA, RGEMMA, GRANITE, STARCODER])
def test_rank_caches_are_the_single_engines_slots(job, arch):
    """(2, 1): every per-slot leaf holds the rank's 2 of 4 slots, equal bit
    for bit to the single engine's rows of them; a pool leaf is the single
    engine's whole pool, bit for bit. (2, 2), mamba2 (tiles split over
    "model", carries whole over it): the same rows on every rank of a data
    block. Per-slot bytes a rank are one engine's / 2 exactly. mamba2's
    carries alone are held to 1e-6 x max|.|: its step's softplus (the
    host's vectorized ``logaddexp``) rounds an element apart by its place
    in the loop, so 2 slots' rows (16 values a head row) round apart from
    4 slots' at the loop's tail; recurrentgemma's and the pools' values are
    equal."""
    path = dict((a, p) for a, p, keep in ENGINES if keep)[arch]
    single = dict(_walk(_single_caches(arch, path)))
    meshes = [(2, 1), (2, 2)] if arch == MAMBA else [(2, 1)]
    for mesh in meshes:
        for rank, r in enumerate(job[0][(f"engine/{arch}/{path}", mesh)]):
            held = dict(_walk(r["caches"]))
            assert sorted(held) == sorted(single)
            d = _data_index(rank, mesh)
            per_slot = 0
            for p, got in held.items():
                want = single[p]
                ax = _slot_axis(p, want, got)
                if ax is None:
                    assert torch.equal(got, want), (mesh, rank, p)
                    continue
                n = got.shape[ax]
                want = want.narrow(ax, d * n, n)
                if arch == MAMBA:
                    tol = 1e-6 * float(want.abs().max())
                    torch.testing.assert_close(got, want, rtol=0, atol=tol)
                else:
                    assert torch.equal(got, want), (mesh, rank, p)
                per_slot += got.numel() * got.element_size()
            whole = sum(single[p].numel() * single[p].element_size() for p in held
                        if _slot_axis(p, single[p], held[p]) is not None)
            assert per_slot * DP == whole
            if arch in (MAMBA, RGEMMA):
                assert per_slot > 0


@pytest.mark.parametrize("arch,mesh", [(GRANITE, (2, 1)), (MAMBA, (2, 1)),
                                       (GRANITE, (2, 2))])
def test_prefix_hit_and_resume_across_data_blocks(job, arch, mesh):
    """Two slots, one a data rank: the hit's pages were written by the
    other block's slot, and the parked request resumes in the other slot
    (on the other data rank), from a snapshot gathered over "data"."""
    per_rank = job[0][(f"control/{arch}", mesh)]
    want = _single_control(arch)
    for key in ("tokens", "steps", "finish", "ticks", "stats", "ptab", "hits"):
        got = _same(per_rank, key)
        if isinstance(got, np.ndarray):
            np.testing.assert_array_equal(got, want[key])
        else:
            assert got == want[key], key
    st = want["stats"]
    assert (st["prefix_hits"], st["preempts"], st["resumes"], st["aborted"]) == (1, 1, 1, 1)


def test_warm_ticks_gather_kv_rows_over_data_once_a_layer(job):
    per_rank = job[0][("warm", (2, 2))]
    cold = job[0][(f"engine/{GRANITE}/float", (2, 2))]
    for key in ("tokens", "steps", "finish", "ticks"):
        assert _same(per_rank, key) == _same(cold, key)
    seq = _same(per_rank, "sequence")
    layers = get_config(GRANITE).reduced().n_layers
    for name in ("decode_tick", "extend_tick"):
        ops = seq[name]
        over_data = [op for op in ops if op[1] == "data"]
        assert len(over_data) == layers, (name, ops)
        cols = 1 if name == "decode_tick" else ENGINE["chunk_tokens"]
        # the new K/V rows of a rank's 2 slots, k and v side by side
        assert all(op[0] == "all_gather" and op[2][:2] == (2, cols) for op in over_data)
        # the tiled layers gather their unique rows over "model" only
        assert all(op[1] in ("data", "model") for op in ops)
    for r in per_rank:
        assert r["retraces"] == 0


def test_qwen_decode_32k_kv_a_rank_on_the_production_meshes(job):
    meta = job[1]
    whole = 177_167_400_960            # 128 slots x 32 768 rows, int8 codes + scales
    assert meta["16x16"][0] == 11_072_962_560 == whole // 16
    assert meta["2x16x16"][0] == 5_536_481_280 == whole // 32
    # time rows over the 16 model ranks, slots over the data ranks
    assert meta["16x16"][1:] == [2048, 8]
    assert meta["2x16x16"][1:] == [2048, 4]
