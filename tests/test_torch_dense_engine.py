"""Port parity for the rest of the dense family in the engine: for
minitron-8b, starcoder2-7b and qwen1.5-32b (on its own int8 KV cache) under
each compute path, the port's ``BatchedEngine`` emits the JAX engine's
greedy tokens, token for token and tick for tick, on the same exported
params (``.reduced()`` size, f32; the JAX engine with ``prefix_cache=False``
and ``telemetry=False``)."""
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
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.weights import params_from_numpy

torch.set_num_threads(2)
ENGINE = dict(n_slots=2, max_len=48, chunk_tokens=8, page_tokens=8)
PROMPT_LENS = (5, 11, 19)


@functools.lru_cache(maxsize=None)
def _export(arch):
    """(JAX reduced config, SERVE params from masters of PRNGKey(1)); the
    SERVE form does not depend on the compute path."""
    cfg = j_get_config(arch).reduced()
    tm = j_build_model(cfg, JModelContext(policy=cfg.tbn, mode=J_TRAIN,
                                          compute_dtype=jnp.float32))
    sm = j_build_model(cfg, JModelContext(policy=cfg.tbn, mode=J_SERVE,
                                          compute_dtype=jnp.float32,
                                          use_pallas=False))
    masters = j_mod.init_params(tm.specs(), jax.random.PRNGKey(1))
    return cfg, j_export(tm.specs(), sm.specs(), masters, cfg.tbn)


@pytest.mark.parametrize("path", ["float", "xnor", "int8"])
@pytest.mark.parametrize("arch", ["minitron-8b", "starcoder2-7b", "qwen1.5-32b"])
def test_greedy_tokens_identical_to_reference_engine(arch, path):
    cfg_j, sp_j = _export(arch)
    sm_j = j_build_model(cfg_j, JModelContext(policy=cfg_j.tbn, mode=J_SERVE,
                                              compute_dtype=jnp.float32,
                                              use_pallas=False, compute_path=path))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg_j.vocab, size=n).astype(np.int32)
               for n in PROMPT_LENS]
    eng_j = JBatchedEngine(sm_j, sp_j, JServeConfig(
        **ENGINE, prefix_cache=False, telemetry=False, compute_path=path))
    reqs_j = [eng_j.submit(p, JSamplingParams(max_tokens=6)) for p in prompts]
    ticks_j = eng_j.run_until_drained()

    cfg = get_config(arch).reduced()
    sm = build_model(cfg, ModelContext(policy=cfg.tbn, mode=SERVE,
                                       compute_dtype=torch.float32,
                                       device="cpu", compute_path=path))
    sp = params_from_numpy(jax.tree.map(np.asarray, sp_j), "cpu")
    eng = BatchedEngine(sm, sp, ServeConfig(**ENGINE, compute_path=path))
    want_kv = torch.int8 if cfg.kv_dtype == "int8" else torch.float32
    assert eng.caches[0]["k"].dtype == want_kv
    reqs = [eng.submit(p, SamplingParams(max_tokens=6)) for p in prompts]
    ticks = eng.run_until_drained()

    assert ticks == ticks_j
    for r, rj in zip(reqs, reqs_j):
        assert r.output == rj.output
        assert r.token_steps == rj.token_steps
        assert r.finish_reason == rj.finish_reason == "length"
    st, st_j = eng.stats(), eng_j.stats()
    for key in ("admitted", "prompt_tokens", "tokens_out", "pool_pages"):
        assert st[key] == st_j[key], key
    assert st["decode_ticks"] > 0 and st["extend_ticks"] > 0
    assert st["pages_in_use"] == 0 and eng.pool.free_pages == eng.pool.n_pages
