"""Port parity: configs, the weight carrier and the SERVE export.

JAX masters for ``granite-8b.reduced()`` cross into the port through
``params_from_numpy``; both packages export them. Tile words must be equal
and alpha within 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build_model as j_build_model
from repro.configs import get_config as j_get_config
from repro.core.policy import tbn_policy as j_tbn_policy
from repro.nn import module as j_mod
from repro.nn.context import SERVE as J_SERVE
from repro.nn.context import TRAIN as J_TRAIN
from repro.nn.context import ModelContext as JModelContext
from repro.nn.linear import Dense as JDense
from repro.serve.weights import export_serving_params as j_export
from repro_torch.configs import build_model, get_config
from repro_torch.core.policy import tbn_policy
from repro_torch.nn import module as mod
from repro_torch.nn.context import SERVE, TRAIN, ModelContext
from repro_torch.nn.linear import Dense
from repro_torch.serve.weights import export_serving_params, params_from_numpy

torch.set_num_threads(2)

CONFIG_FIELDS = ("name", "family", "n_layers", "d_model", "n_heads", "n_kv",
                 "d_ff", "vocab", "head_dim", "window", "qkv_bias", "qk_norm",
                 "activation", "gated_mlp", "norm", "tie_embeddings",
                 "rope_theta", "kv_dtype")


@pytest.mark.parametrize("reduced", [False, True])
def test_granite_config_matches_reference(reduced):
    cj, ct = j_get_config("granite-8b"), get_config("granite-8b")
    if reduced:
        cj, ct = cj.reduced(), ct.reduced()
    for f in CONFIG_FIELDS:
        assert getattr(ct, f) == getattr(cj, f), f
    assert dataclasses.asdict(ct.tbn) == dataclasses.asdict(cj.tbn)


def test_unported_configs_and_families_raise():
    with pytest.raises(NotImplementedError, match="item 6"):
        get_config("seamless-m4t-large-v2")
    cfg = dataclasses.replace(get_config("granite-8b").reduced(), family="encdec")
    with pytest.raises(NotImplementedError, match="item 6"):
        build_model(cfg, ModelContext(policy=cfg.tbn, device="cpu"))


def _leaves(tree):
    return {"/".join(p): v for p, v in mod.walk(tree)}


def test_export_matches_reference():
    cfg_j = j_get_config("granite-8b").reduced()
    tm_j = j_build_model(cfg_j, JModelContext(policy=cfg_j.tbn, mode=J_TRAIN,
                                              compute_dtype=jnp.float32))
    sm_j = j_build_model(cfg_j, JModelContext(policy=cfg_j.tbn, mode=J_SERVE,
                                              compute_dtype=jnp.float32,
                                              use_pallas=False))
    masters_j = j_mod.init_params(tm_j.specs(), jax.random.PRNGKey(3))
    sp_j = _leaves(jax.tree.map(np.asarray,
                                j_export(tm_j.specs(), sm_j.specs(), masters_j,
                                         cfg_j.tbn)))

    cfg = get_config("granite-8b").reduced()
    tm = build_model(cfg, ModelContext(policy=cfg.tbn, mode=TRAIN,
                                       compute_dtype=torch.float32, device="cpu"))
    sm = build_model(cfg, ModelContext(policy=cfg.tbn, mode=SERVE,
                                       compute_dtype=torch.float32, device="cpu"))
    masters = params_from_numpy(jax.tree.map(np.asarray, masters_j), "cpu")
    # the carrier keeps every key path and value
    for path, v in _leaves(masters).items():
        assert path in _leaves(jax.tree.map(np.asarray, masters_j))
    sp = _leaves(export_serving_params(tm.specs(), sm.specs(), masters, cfg.tbn))
    # same leaves, same shapes as both packages' SERVE declarations
    assert set(sp) == set(sp_j) == set(_leaves(sm.specs()))
    n_tiles = 0
    for path, want in sp_j.items():
        got = sp[path].numpy()
        assert got.shape == want.shape, path
        if path.endswith("tile"):
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, want, err_msg=path)
            n_tiles += 1
        elif path.endswith("alpha"):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=path)
        else:
            np.testing.assert_array_equal(got, want, err_msg=path)
    assert n_tiles == 8     # 7 stacked per-layer projections + the LM head


def test_carrier_handles_bf16_leaves():
    a = np.asarray(jnp.asarray([[1.5, -2.0], [0.25, 3.0]], jnp.bfloat16))
    got = params_from_numpy({"x": {"w": a}}, "cpu")["x"]["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), a.astype(np.float32))


def test_unaligned_flat_tile_export_and_apply_match_reference():
    """p ∤ n_out (policy without the alignment requirement): the flat q-bit
    tile and its dense-reconstruction apply."""
    n_in, n_out = 48, 34
    pol_j = j_tbn_policy(p=3, min_size=1, alpha_source="W", require_aligned=False)
    pol_t = tbn_policy(p=3, min_size=1, alpha_source="W", require_aligned=False)
    d_tr_j = JDense(n_in, n_out, JModelContext(policy=pol_j, mode=J_TRAIN))
    d_sv_j = JDense(n_in, n_out, JModelContext(policy=pol_j, mode=J_SERVE,
                                               compute_dtype=jnp.float32,
                                               use_pallas=False))
    d_tr = Dense(n_in, n_out, ModelContext(policy=pol_t, mode=TRAIN, device="cpu"))
    d_sv = Dense(n_in, n_out, ModelContext(policy=pol_t, mode=SERVE,
                                           compute_dtype=torch.float32,
                                           device="cpu"))
    assert not d_sv.spec.aligned_rows
    rng = np.random.default_rng(0)
    w = rng.standard_normal((n_out, n_in)).astype(np.float32)
    sp_j = j_export(d_tr_j.specs(), d_sv_j.specs(), {"w": jnp.asarray(w)}, pol_j)
    sp = export_serving_params(d_tr.specs(), d_sv.specs(),
                               {"w": torch.from_numpy(w)}, pol_t)
    np.testing.assert_array_equal(sp["tile"].numpy(), np.asarray(sp_j["tile"]))
    np.testing.assert_allclose(sp["alpha"].numpy(), np.asarray(sp_j["alpha"]),
                               atol=1e-6)
    x = rng.standard_normal((5, n_in)).astype(np.float32)
    np.testing.assert_allclose(
        d_sv(sp, torch.from_numpy(x)).numpy(),
        np.asarray(d_sv_j(sp_j, jnp.asarray(x))), rtol=1e-4, atol=1e-4)
