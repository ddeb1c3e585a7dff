"""Port parity: the ``BatchedEngine`` emits the JAX engine's greedy tokens,
token for token and tick for tick, on the same exported params (f32
compute; the JAX engine with ``prefix_cache=False`` and
``telemetry=False``)."""
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
from repro_torch.serve.sampling import SamplingParams, row_seed, sample_logits_batch
from repro_torch.serve.weights import params_from_numpy

torch.set_num_threads(2)
ENGINE = dict(n_slots=2, max_len=48, chunk_tokens=8, page_tokens=8)
PROMPT_LENS = (5, 11, 19)


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in PROMPT_LENS]


def test_greedy_tokens_identical_to_reference_engine():
    cfg_j = j_get_config("granite-8b").reduced()
    tm_j = j_build_model(cfg_j, JModelContext(policy=cfg_j.tbn, mode=J_TRAIN,
                                              compute_dtype=jnp.float32))
    sm_j = j_build_model(cfg_j, JModelContext(policy=cfg_j.tbn, mode=J_SERVE,
                                              compute_dtype=jnp.float32,
                                              use_pallas=False))
    masters = j_mod.init_params(tm_j.specs(), jax.random.PRNGKey(1))
    sp_j = j_export(tm_j.specs(), sm_j.specs(), masters, cfg_j.tbn)
    eng_j = JBatchedEngine(sm_j, sp_j, JServeConfig(
        **ENGINE, prefix_cache=False, telemetry=False))
    reqs_j = [eng_j.submit(p, JSamplingParams(max_tokens=4))
              for p in _prompts(cfg_j.vocab)]
    ticks_j = eng_j.run_until_drained()

    cfg = get_config("granite-8b").reduced()
    sm = build_model(cfg, ModelContext(policy=cfg.tbn, mode=SERVE,
                                       compute_dtype=torch.float32, device="cpu"))
    sp = params_from_numpy(jax.tree.map(np.asarray, sp_j), "cpu")
    eng = BatchedEngine(sm, sp, ServeConfig(**ENGINE))
    reqs = [eng.submit(p, SamplingParams(max_tokens=4))
            for p in _prompts(cfg.vocab)]
    ticks = eng.run_until_drained()

    assert ticks == ticks_j
    for r, rj in zip(reqs, reqs_j):
        assert r.output == rj.output
        assert r.token_steps == rj.token_steps
        assert r.finish_reason == rj.finish_reason == "length"
    st, st_j = eng.stats(), eng_j.stats()
    for key in ("admitted", "prompt_tokens", "tokens_out", "pool_pages"):
        assert st[key] == st_j[key], key
    assert st["pages_in_use"] == 0 and eng.pool.free_pages == eng.pool.n_pages
    eng.pool.check()


def test_sampling_is_per_request_and_reproducible():
    """Temperature/top-k rows depend only on their own seed; greedy rows
    ignore theirs."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn((3, 50), generator=g)
    seeds = [row_seed((0, 5), 2), None, row_seed((0, 9), 0)]
    a = sample_logits_batch(logits, [0.8, 0.0, 1.5], [5, 3, 0], seeds)
    b = sample_logits_batch(logits[[2, 1, 0]], [1.5, 0.0, 0.8], [0, 3, 5],
                            seeds[::-1])
    assert a.tolist() == b[[2, 1, 0]].tolist()
    assert a[1] == logits[1].argmax()
    assert a[0] in torch.topk(logits[0], 5).indices
    assert row_seed((0, 5), 2) != row_seed((0, 5), 3)


def test_engine_validates_requests_and_config():
    with pytest.raises(ValueError):
        ServeConfig(max_len=48, page_tokens=7)
    with pytest.raises(ValueError):
        ServeConfig(max_len=16, chunk_tokens=32)
    cfg = get_config("granite-8b").reduced()
    sm = build_model(cfg, ModelContext(policy=cfg.tbn, mode=SERVE,
                                       compute_dtype=torch.float32, device="cpu"))
    from repro_torch.nn import module as mod

    sp = mod.init_params(sm.specs(), 0, "cpu")
    eng = BatchedEngine(sm, sp, ServeConfig(**ENGINE))
    with pytest.raises(ValueError):
        eng.submit(np.zeros((49,), np.int32))
    with pytest.raises(ValueError):
        eng.submit(np.zeros((0,), np.int32))
