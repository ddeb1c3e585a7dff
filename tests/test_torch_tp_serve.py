"""Tensor- and expert-parallel serving of the port on gloo ranks on the CPU,
against the JAX package on one device (its ``tests/test_distributed.py``
TestShardedServe, which runs the reference under its own meshes).

Two jobs of ``tests/torch_mesh_worker.py`` ranks, each started once for the
module: 2 ranks with the (1, 2) mesh and 4 ranks with (1, 4) and (2, 2).
Under each mesh the ranks hold r/TP tile rows (E/TP experts of a MoE bank)
and gather the rest; every rank must hold the same outputs, and:

* ``tiled_dense_infer`` at m in {1, 3, 8, 33, 70} under each compute path
  equals the JAX single-device function at rtol = atol = 1e-4, and the
  integer paths equal the port on one device exactly (their int32
  accumulators are exact and the per-row scales are the same);
* ``tiled_conv_infer`` likewise at 1e-4;
* granite-8b ``.reduced()`` in f32: prefill of one prompt and 4 greedy
  decode steps within atol 1e-5 of JAX's logits, each rank holding 1/TP
  of the tile bytes; the engine's greedy tokens equal the JAX engine's
  under (1, 4), where 4 does not divide its 2 K/V heads and each rank's
  pool holds both, and under (2, 2), where each rank attends on its block
  of the heads and its pool holds 1 of the 2 (``attn_act`` "heads"), on
  the first rank, which takes the requests, and on the others, which
  follow it; a mixed greedy / stochastic batch
  gives the port's single-device tokens (stochastic tokens do not compare
  across packages);
* qwen2-moe-a2.7b ``.reduced()`` (E = 8, expert parallel) under (1, 2) and
  (1, 4): logits within 1e-4 and engine tokens equal to JAX's; with the
  "experts" rule off the banks' tile rows shard instead and are gathered
  before the rebuild, to the same logits.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build_model as j_build_model
from repro.configs import get_config as j_get_config
from repro.core.packing import pack_bits as j_pack_bits
from repro.core.packing import pack_conv_tile as j_pack_conv_tile
from repro.core.tiling import plan_tiling as j_plan_tiling
from repro.kernels import ops as j_ops
from repro.nn import module as j_mod
from repro.nn.context import SERVE as J_SERVE
from repro.nn.context import TRAIN as J_TRAIN
from repro.nn.context import ModelContext as JModelContext
from repro.serve.engine import BatchedEngine as JBatchedEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.sampling import SamplingParams as JSamplingParams
from repro.serve.weights import export_serving_params as j_export
from repro.serve.weights import tile_serving_bytes as j_tile_bytes
from repro_torch.configs import build_model, get_config
from repro_torch.core.tiling import plan_tiling
from repro_torch.kernels import ops
from repro_torch.nn.context import SERVE, ModelContext
from repro_torch.serve.engine import BatchedEngine, ServeConfig
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.weights import params_from_numpy
from torch_mesh_worker import finish_job, start_job

torch.set_num_threads(2)
PATHS = ("float", "xnor", "int8")
MS = (1, 3, 8, 33, 70)
RTOL = 1e-4
LOGIT_ATOL = 1e-5
GRANITE, MOE = "granite-8b", "qwen2-moe-a2.7b"
PROMPT = [5, 3, 2, 7, 1, 4, 6, 2]
ENGINE = dict(n_slots=3, max_len=64, chunk_tokens=8)
PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9]]
GREEDY = [dict(max_tokens=4)] * 3
MIXED = [dict(temperature=0.0, max_tokens=4), dict(temperature=1.0, max_tokens=4),
         dict(temperature=1.0, top_k=2, max_tokens=4)]
MIXED_ENGINE = dict(ENGINE, temperature=0.7, seed=11)
N_IN, R, P = 80, 64, 4     # 80 = 2.5 words: the rows carry pad bits


def _dense_inputs():
    rng = np.random.default_rng(3)
    t = np.where(rng.random((R, N_IN)) < 0.5, 1.0, -1.0).astype(np.float32)
    kw = dict(p=P, min_size=1, alpha_source="W")
    spec_t = plan_tiling((P * R, N_IN), **kw)
    return dict(rows=np.array(j_pack_bits(jnp.asarray(t))),
                alpha=rng.uniform(0.1, 1.1, spec_t.n_alpha).astype(np.float32),
                xs={m: rng.standard_normal((m, N_IN)).astype(np.float32)
                    for m in MS},
                spec_t=spec_t, spec_j=j_plan_tiling((P * R, N_IN), **kw))


def _conv_inputs():
    rng = np.random.default_rng(5)
    shape = (2 * 16, 8, 3, 3)           # p = 2: r = 16 unique filters
    kw = dict(p=2, min_size=1, alpha_source="W")
    spec_t = plan_tiling(shape, **kw)
    t = np.where(rng.random(spec_t.q) < 0.5, 1.0, -1.0).astype(np.float32)
    spec_j = j_plan_tiling(shape, **kw)
    return dict(packed=np.array(j_pack_conv_tile(jnp.asarray(t), 16, 8, 3, 3)),
                alpha=rng.uniform(0.1, 1.1, spec_t.n_alpha).astype(np.float32),
                x=rng.standard_normal((4, 9, 9, 8)).astype(np.float32),
                stride=(2, 2), padding="SAME", spec_t=spec_t, spec_j=spec_j)


@functools.lru_cache(maxsize=None)
def _export(arch):
    """(JAX reduced config, its SERVE params as numpy) from the masters of
    PRNGKey(0), f32."""
    cfg = j_get_config(arch).reduced()
    tm = j_build_model(cfg, JModelContext(policy=cfg.tbn, mode=J_TRAIN,
                                          compute_dtype=jnp.float32))
    sm = j_build_model(cfg, _jctx(cfg))
    sp = j_export(tm.specs(), sm.specs(),
                  j_mod.init_params(tm.specs(), jax.random.PRNGKey(0)), cfg.tbn)
    return cfg, jax.tree.map(np.asarray, sp)


def _jctx(cfg):
    return JModelContext(policy=cfg.tbn, mode=J_SERVE, compute_dtype=jnp.float32,
                         use_pallas=False)


def _model_case(kind, arch, meshes, **kw):
    return dict(kind=kind, arch=arch, meshes=meshes, dtype="float32",
                sp=_export(arch)[1], **kw)


@functools.lru_cache(maxsize=None)
def _jax_logits(arch):
    cfg, sp = _export(arch)
    sm = j_build_model(cfg, _jctx(cfg))
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
def _jax_tokens(arch):
    cfg, sp = _export(arch)
    eng = JBatchedEngine(j_build_model(cfg, _jctx(cfg)), sp, JServeConfig(
        **ENGINE, prefix_cache=False, telemetry=False))
    reqs = [eng.submit(p, JSamplingParams(**kw)) for p, kw in zip(PROMPTS, GREEDY)]
    eng.run_until_drained()
    return [r.output for r in reqs]


def _port_single_tokens(arch, sampling, engine):
    cfg = get_config(arch).reduced()
    sm = build_model(cfg, ModelContext(policy=cfg.tbn, mode=SERVE,
                                       compute_dtype=torch.float32, device="cpu"))
    eng = BatchedEngine(sm, params_from_numpy(_export(arch)[1], "cpu"),
                        ServeConfig(**engine))
    reqs = [eng.submit(np.asarray(p, np.int32), SamplingParams(**kw))
            for p, kw in zip(PROMPTS, sampling)]
    eng.run_until_drained()
    return [r.output for r in reqs]


def _cases(meshes_two, meshes_four):
    """The two jobs' case lists (index -> case); the cases name the meshes
    they run under."""
    d, c = _dense_inputs(), _conv_inputs()
    dense = lambda ms: dict(kind="dense", meshes=ms, paths=PATHS, xs=d["xs"],
                            rows=d["rows"], alpha=d["alpha"],
                            spec=dataclasses.asdict(d["spec_t"]))
    conv = dict(kind="conv", meshes=meshes_four, packed=c["packed"],
                alpha=c["alpha"], x=c["x"], stride=c["stride"],
                padding=c["padding"], spec=dataclasses.asdict(c["spec_t"]))
    moe_logits = _model_case("logits", MOE, None, prompt=PROMPT, max_len=16,
                             decode_steps=4)
    moe_engine = _model_case("engine", MOE, None, engine=ENGINE, prompts=PROMPTS,
                             sampling=GREEDY)
    two = {"dense": dense(meshes_two),
           "moe_logits": dict(moe_logits, meshes=meshes_two),
           "moe_rows": dict(moe_logits, meshes=meshes_two, rules={"experts": None}),
           "moe_engine": dict(moe_engine, meshes=meshes_two)}
    four = {"dense": dense(meshes_four), "conv": conv,
            "granite_logits": _model_case("logits", GRANITE, [(1, 4)], prompt=PROMPT,
                                          max_len=16, decode_steps=4),
            "granite_engine": _model_case("engine", GRANITE, meshes_four,
                                          engine=ENGINE, prompts=PROMPTS,
                                          sampling=GREEDY),
            "granite_mixed": _model_case("engine", GRANITE, [(1, 4)],
                                         engine=MIXED_ENGINE, prompts=PROMPTS,
                                         sampling=MIXED),
            "moe_logits": dict(moe_logits, meshes=[(1, 4)]),
            "moe_engine": dict(moe_engine, meshes=[(1, 4)])}
    return two, four


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """name -> {mesh: [each rank's result]} over both jobs (run at once)."""
    two, four = _cases([(1, 2)], [(1, 4), (2, 2)])
    started = []
    for world, meshes, cases in ((2, [(1, 2)], two), (4, [(1, 4), (2, 2)], four)):
        names = list(cases)
        job = dict(device="cpu", meshes=meshes, cases=[cases[n] for n in names])
        started.append((names, cases, start_job(
            job, world, tmp_path_factory.mktemp(f"mesh{world}"))))
    out = {}
    for names, cases, handle in started:
        ranks = finish_job(handle)
        for i, name in enumerate(names):
            for dims in cases[name]["meshes"]:
                out.setdefault(name, {})[tuple(dims)] = [r[(i, tuple(dims))]
                                                         for r in ranks]
    return out


def _same_on_every_rank(per_rank, key):
    first = per_rank[0][key]
    for r in per_rank[1:]:
        if isinstance(first, torch.Tensor):
            assert torch.equal(r[key], first)
        elif isinstance(first, list) and isinstance(first[0], torch.Tensor):
            assert all(torch.equal(a, b) for a, b in zip(r[key], first, strict=True))
        else:
            assert r[key] == first
    return first


DENSE_MESHES = [(1, 2), (1, 4), (2, 2)]


@functools.lru_cache(maxsize=None)
def _dense_want(path, m):
    """(JAX single-device output, the port's on one device)."""
    d = _dense_inputs()
    want = np.asarray(jax.jit(functools.partial(
        j_ops.tiled_dense_infer, spec=d["spec_j"], use_pallas=False,
        compute_path=path))(jnp.asarray(d["xs"][m]), jnp.asarray(d["rows"]),
                            jnp.asarray(d["alpha"])))
    one = ops.tiled_dense_infer(torch.from_numpy(d["xs"][m]),
                                torch.from_numpy(d["rows"]),
                                torch.from_numpy(d["alpha"]), d["spec_t"],
                                compute_path=path)
    return want, one


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("dims", DENSE_MESHES)
def test_tiled_dense_infer_per_shard(jobs, dims, path, m):
    ranks = jobs["dense"][dims]
    assert all(r["rows_held"] == R // dims[1] for r in ranks)
    got = _same_on_every_rank(ranks, f"{path}/{m}")
    want, one = _dense_want(path, m)
    assert got.shape == (m, P * R)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL)
    if path != "float":
        assert torch.equal(got, one)


@pytest.mark.parametrize("dims", [(1, 4), (2, 2)])
def test_tiled_conv_infer_per_shard(jobs, dims):
    c = _conv_inputs()
    ranks = jobs["conv"][dims]
    assert all(r["filters_held"] == 16 // dims[1] for r in ranks)
    got = _same_on_every_rank(ranks, "y")
    want = np.asarray(j_ops.tiled_conv_infer(
        jnp.asarray(c["x"]), jnp.asarray(c["packed"]), jnp.asarray(c["alpha"]),
        c["spec_j"], stride=c["stride"], padding=c["padding"], use_pallas=False))
    assert got.shape == want.shape == (4, 5, 5, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL)


def _check_logits(per_rank, arch, atol):
    want = _jax_logits(arch)
    got = _same_on_every_rank(per_rank, "logits")
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol)
        assert (g.argmax(-1).numpy() == w.argmax(-1)).all()


def test_granite_logits_and_tile_bytes_under_tp(jobs):
    per_rank = jobs["granite_logits"][(1, 4)]
    _check_logits(per_rank, GRANITE, LOGIT_ATOL)
    per_dev = _same_on_every_rank(per_rank, "tile_bytes")
    total = j_tile_bytes(_export(GRANITE)[1])
    assert len(per_dev) == 4 and all(k.startswith("rank ") for k in per_dev)
    assert all(v * 4 == total for v in per_dev.values()), (per_dev, total)


@pytest.mark.parametrize("dims", [(1, 4), (2, 2)])
def test_granite_engine_tokens_equal_reference(jobs, dims):
    per_rank = jobs["granite_engine"][dims]
    assert _same_on_every_rank(per_rank, "tokens") == _jax_tokens(GRANITE)
    _same_on_every_rank(per_rank, "ticks")
    assert [r["first"] for r in per_rank] == [True, False, False, False]
    # the pools' K/V heads a rank: the model axis of 2 divides the reduced
    # n_kv = 2, that of 4 does not
    heads = {shape[-2] for path, shape in
             _same_on_every_rank(per_rank, "cache_shapes").items()
             if path.split("/")[-1] in ("k", "v")}
    assert heads == ({1} if dims[1] == 2 else {2})


def test_mixed_sampling_equal_single_device(jobs):
    got = _same_on_every_rank(jobs["granite_mixed"][(1, 4)], "tokens")
    assert got == _port_single_tokens(GRANITE, MIXED, MIXED_ENGINE)
    assert got[0] == _port_single_tokens(GRANITE, GREEDY, ENGINE)[0]


@pytest.mark.parametrize("dims", [(1, 2), (1, 4)])
def test_moe_expert_parallel_logits_and_tokens(jobs, dims):
    _check_logits(jobs["moe_logits"][dims], MOE, RTOL)
    assert _same_on_every_rank(jobs["moe_engine"][dims], "tokens") == _jax_tokens(MOE)


def test_moe_bank_rows_gathered_where_experts_do_not_shard(jobs):
    _check_logits(jobs["moe_rows"][(1, 2)], MOE, RTOL)
