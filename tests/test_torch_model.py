"""Port parity: ``DecoderLM`` SERVE ``extend`` then ``decode_step`` logits
match the JAX model's, f32 compute on both sides, same exported params,
paged K/V pool. Also: invalid paged writes are dropped."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build_model as j_build_model
from repro.configs import get_config as j_get_config
from repro.nn import attention as j_attention
from repro.nn import module as j_mod
from repro.nn.context import SERVE as J_SERVE
from repro.nn.context import TRAIN as J_TRAIN
from repro.nn.context import ModelContext as JModelContext
from repro.serve.weights import export_serving_params as j_export
from repro_torch.configs import build_model, get_config
from repro_torch.nn import attention
from repro_torch.nn.context import SERVE, ModelContext
from repro_torch.serve.weights import params_from_numpy

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
B, PT, N_PAGES, NPP = 2, 8, 12, 6          # 2 slots, max_len 48


@functools.lru_cache(maxsize=None)
def _models():
    cfg_j = j_get_config("granite-8b").reduced()
    tm_j = j_build_model(cfg_j, JModelContext(policy=cfg_j.tbn, mode=J_TRAIN,
                                              compute_dtype=jnp.float32))
    sm_j = j_build_model(cfg_j, JModelContext(policy=cfg_j.tbn, mode=J_SERVE,
                                              compute_dtype=jnp.float32,
                                              use_pallas=False))
    masters = j_mod.init_params(tm_j.specs(), jax.random.PRNGKey(0))
    sp_j = j_export(tm_j.specs(), sm_j.specs(), masters, cfg_j.tbn)
    cfg = get_config("granite-8b").reduced()
    sm = build_model(cfg, ModelContext(policy=cfg.tbn, mode=SERVE,
                                       compute_dtype=torch.float32, device="cpu"))
    sp = params_from_numpy(jax.tree.map(np.asarray, sp_j), "cpu")
    return cfg, sm_j, sp_j, sm, sp


@pytest.mark.parametrize("n_new", [(7, 3), (8, 0)])
def test_extend_then_decode_logits_match_reference(n_new):
    cfg, sm_j, sp_j, sm, sp = _models()
    rng = np.random.default_rng(sum(n_new))
    tokens = rng.integers(0, cfg.vocab, size=(B, 8)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab, size=(B, 1)).astype(np.int32)
    ptab = rng.permutation(N_PAGES)[: B * NPP].reshape(B, NPP).astype(np.int32)
    n_new = np.asarray(n_new, np.int32)
    # second chunk: continue both slots from where the first left them
    tokens2 = rng.integers(0, cfg.vocab, size=(B, 8)).astype(np.int32)
    n_new2 = np.asarray([5, 8], np.int32)
    active = np.asarray([True, False])

    caches_j = sm_j.init_caches(B, NPP * PT, jnp.float32, page_tokens=PT,
                                n_pages=N_PAGES)
    len_j = jnp.zeros((B,), jnp.int32)
    le_j, caches_j, len_j = sm_j.extend(sp_j, jnp.asarray(tokens), caches_j,
                                        len_j, jnp.asarray(n_new),
                                        page_table=jnp.asarray(ptab))
    le2_j, caches_j, len_j = sm_j.extend(sp_j, jnp.asarray(tokens2), caches_j,
                                         len_j, jnp.asarray(n_new2),
                                         page_table=jnp.asarray(ptab))
    ld_j, _, _ = sm_j.decode_step(sp_j, jnp.asarray(nxt), caches_j, len_j,
                                  page_table=jnp.asarray(ptab),
                                  active=jnp.asarray(active))

    caches = sm.init_caches(N_PAGES, PT, torch.float32)
    lengths = torch.zeros((B,), dtype=torch.int32)
    t = torch.from_numpy
    le, caches, lengths = sm.extend(sp, t(tokens).long(), caches, lengths,
                                    t(n_new), t(ptab))
    le2, caches, lengths = sm.extend(sp, t(tokens2).long(), caches, lengths,
                                     t(n_new2), t(ptab))
    ld, _, _ = sm.decode_step(sp, t(nxt).long(), caches, lengths, t(ptab),
                              active=t(active))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(len_j))
    live = n_new > 0     # a slot with n_new == 0 has meaningless logits
    np.testing.assert_allclose(le.numpy()[live], np.asarray(le_j)[live], **TOL)
    np.testing.assert_allclose(le2.numpy(), np.asarray(le2_j), **TOL)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ld_j), **TOL)


def test_invalid_paged_writes_are_dropped():
    """Padding columns, positions past the table and negative positions
    never touch a mapped page; the reference drops them out of bounds, the
    port routes them to the scratch page."""
    rng = np.random.default_rng(0)
    n_pages, pt, npp = 4, 2, 2
    pool0 = rng.standard_normal((n_pages, pt, 3)).astype(np.float32)
    table = np.asarray([[2, 0], [1, 3]], np.int32)
    positions = np.asarray([[0, 3, 4, -1], [1, 2, 9, 3]], np.int32)
    valid = np.asarray([[True, False, True, True], [True, True, True, False]])
    values = rng.standard_normal((2, 4, 3)).astype(np.float32)
    want = np.asarray(j_attention.scatter_pages(
        jnp.asarray(pool0), jnp.asarray(table), jnp.asarray(positions),
        jnp.asarray(values), jnp.asarray(valid)))
    pool = torch.from_numpy(np.concatenate([pool0, np.zeros((1, pt, 3),
                                                           np.float32)]))
    attention.scatter_pages(pool, torch.from_numpy(table),
                            torch.from_numpy(positions),
                            torch.from_numpy(values), torch.from_numpy(valid))
    np.testing.assert_array_equal(pool[:n_pages].numpy(), want)
    # exactly the three valid in-reach writes landed
    assert int((pool[:n_pages].numpy() != pool0).any(-1).sum()) == 3
    view = attention.gather_pages(pool, torch.from_numpy(table))
    np.testing.assert_array_equal(
        view.numpy(), np.asarray(j_attention.gather_pages(jnp.asarray(want),
                                                          jnp.asarray(table))))
