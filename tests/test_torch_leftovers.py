"""The last pieces of the JAX package ported: the synthetic datasets, the
``core`` helpers (``storage_bytes``, ``pack_tile_matrix`` /
``unpack_tile_matrix``, ``pack_bits_np``, ``tile_as_matrix``,
``fold_inputs_reference``), ``core/collapse.py`` and
``nn/module.param_count`` / ``abstract_params``, each against the
reference on numpy inputs from a seed.

Integer results (words, byte counts, labels) are exact; f32 results within
rtol 1e-5, atol 1e-5 * max|y| (reordered sums). The generators draw from
``torch.Generator`` where the reference draws from threefry, so their
values differ: each is held to the reference's rule on the port's own
draws (the labels a fixed teacher gives, the anchors a cloud is built
from, the sines, the textures), to determinism in (seed, step, shard) and
to its shapes and dtypes.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import build_model as j_build_model
from repro.configs import get_config as j_get_config
from repro.core import collapse as j_collapse
from repro.core import packing as j_packing
from repro.core import tiling as j_tiling
from repro.data import synthetic as j_synth
from repro.nn import module as j_mod
from repro.nn.context import TRAIN as J_TRAIN
from repro.nn.context import ModelContext as JModelContext
from repro_torch.configs import build_model, get_config
from repro_torch.core import collapse, packing, tiling
from repro_torch.data import synthetic
from repro_torch.nn import module as mod
from repro_torch.nn.context import TRAIN, ModelContext

TOL = 1e-5


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=TOL,
                               atol=TOL * float(np.abs(want).max() or 1.0))


# ---------------------------------------------------------------------------
# synthetic datasets
# ---------------------------------------------------------------------------
def test_teacher_mlp_labels_follow_the_teacher_rule():
    x, y = synthetic.teacher_mlp(3, 5, 16, 12, 4, shard=1)
    w1, w2 = synthetic.teacher_weights(3, 12, 4)
    jx, jy = j_synth.teacher_mlp(3, 5, 16, 12, 4, shard=1)
    assert (x.shape, x.dtype, y.shape) == (tuple(jx.shape), torch.float32, tuple(jy.shape))
    want = jnp.argmax(jnp.tanh(jnp.asarray(x.numpy()) @ jnp.asarray(w1.numpy()))
                      @ jnp.asarray(w2.numpy()), axis=-1)
    np.testing.assert_array_equal(y.numpy(), np.asarray(want))
    assert 0 <= int(y.min()) and int(y.max()) < 4


def test_point_cloud_is_built_from_its_class_anchors():
    pts, labels = synthetic.point_cloud(1, 2, 6, 50, 3)
    jp, jl = j_synth.point_cloud(1, 2, 6, 50, 3)
    assert tuple(pts.shape) == tuple(jp.shape) and tuple(labels.shape) == tuple(jl.shape)
    anchors = synthetic.cloud_anchors(1, 3)
    # every point lies within 0.1 * 6 sigma of one of its class's 8 anchors
    d = (pts[:, :, None, :] - anchors[labels][:, None, :, :]).norm(dim=-1)
    assert float(d.min(dim=-1).values.max()) < 0.1 * 6 * math.sqrt(3)


def test_sine_mixture_is_the_reference_rule_plus_small_noise():
    series = synthetic.sine_mixture(2, 1, 3, 40, 5)
    ref = j_synth.sine_mixture(2, 1, 3, 40, 5)
    assert tuple(series.shape) == tuple(ref.shape) == (3, 40, 5)
    freqs, amps = synthetic.sine_params(2, 5)
    assert float(freqs.min()) >= 0.02 and float(freqs.max()) < 0.3
    # remove the fixed sines' envelope: what is left is bounded by the
    # amplitudes plus the 0.05 noise
    bound = amps.sum(-1)[None, None, :] + 0.05 * 6
    assert bool((series.abs() <= bound).all())


def test_image_like_is_the_class_texture_plus_noise():
    x, labels = synthetic.image_like(4, 3, 5, 8, 3)
    jx, jl = j_synth.image_like(4, 3, 5, 8, 3)
    assert tuple(x.shape) == tuple(jx.shape) and tuple(labels.shape) == tuple(jl.shape)
    resid = x - synthetic.image_patterns(4, 8, 3)[labels]
    assert abs(float(resid.std()) - 0.5) < 0.1


@pytest.mark.parametrize("gen,args", [
    (synthetic.teacher_mlp, (8, 12, 4)), (synthetic.point_cloud, (4, 16, 3)),
    (synthetic.sine_mixture, (2, 16, 3)), (synthetic.image_like, (2, 8, 3))])
def test_generators_are_pure_in_seed_step_and_shard(gen, args):
    flat = lambda out: [t.numpy() for t in (out if isinstance(out, tuple) else (out,))]
    a, b = flat(gen(7, 3, *args)), flat(gen(7, 3, *args))
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)
    for other in (gen(7, 4, *args), gen(7, 3, *args, shard=1), gen(8, 3, *args)):
        assert not np.array_equal(flat(other)[0], a[0])


# ---------------------------------------------------------------------------
# core helpers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("q,n_alpha", [(1, 1), (32, 8), (33, 4), (4096 * 512, 8)])
def test_storage_bytes_matches_reference(q, n_alpha):
    assert packing.storage_bytes(q, n_alpha) == j_packing.storage_bytes(q, n_alpha)


@pytest.mark.parametrize("shape", [(5, 33), (2, 3, 64), (7,), (1, 100)])
def test_pack_bits_np_and_tile_matrix_match_reference(shape):
    rng = np.random.default_rng(sum(shape))
    t = np.where(rng.standard_normal(shape) > 0, 1.0, -1.0).astype(np.float32)
    want = np.asarray(j_packing.pack_bits_np(t))
    np.testing.assert_array_equal(packing.pack_bits_np(t), want)
    if len(shape) == 2:
        words = packing.pack_tile_matrix(torch.from_numpy(t))
        np.testing.assert_array_equal(
            words.numpy(), np.asarray(j_packing.pack_tile_matrix(jnp.asarray(t))))
        np.testing.assert_array_equal(
            packing.unpack_tile_matrix(words, shape[1]).numpy(),
            np.asarray(j_packing.unpack_tile_matrix(jnp.asarray(want), shape[1])))


def _spec_pair(shape, p, alpha_mode):
    kw = dict(p=p, min_size=1, alpha_mode=alpha_mode, alpha_source="W")
    return tiling.plan_tiling(shape, **kw), j_tiling.plan_tiling(shape, **kw)


@pytest.mark.parametrize("alpha_mode", ["layer", "tile"])
@pytest.mark.parametrize("shape,p", [((64, 48), 4), ((32, 96), 8), ((48, 48), 2)])
def test_tile_as_matrix_and_fold_inputs_match_reference(shape, p, alpha_mode):
    spec_t, spec_j = _spec_pair(shape, p, alpha_mode)
    rng = np.random.default_rng(p)
    t = np.where(rng.standard_normal(spec_t.q) > 0, 1.0, -1.0).astype(np.float32)
    alpha = rng.random(spec_t.n_alpha).astype(np.float32) + 0.1
    np.testing.assert_array_equal(
        tiling.tile_as_matrix(torch.from_numpy(t), spec_t).numpy(),
        np.asarray(j_tiling.tile_as_matrix(jnp.asarray(t), spec_j)))
    x = rng.standard_normal((3, 5, shape[0])).astype(np.float32)
    _close(tiling.fold_inputs_reference(torch.from_numpy(x), torch.from_numpy(t),
                                        torch.from_numpy(alpha), spec_t).numpy(),
           j_tiling.fold_inputs_reference(jnp.asarray(x), jnp.asarray(t),
                                          jnp.asarray(alpha), spec_j))


def test_tile_as_matrix_refuses_what_the_reference_refuses():
    flat = tiling.plan_tiling((4096,), p=4, min_size=1)
    with pytest.raises(ValueError):
        tiling.tile_as_matrix(torch.ones(flat.q), flat)


@pytest.mark.parametrize("alpha_mode", ["layer", "tile"])
@pytest.mark.parametrize("n_out1,n_in,n_out2,p", [(64, 48, 24, 4), (32, 16, 40, 8)])
def test_collapse_matches_reference(n_out1, n_in, n_out2, p, alpha_mode):
    spec_t, spec_j = _spec_pair((n_out1, n_in), p, alpha_mode)
    rng = np.random.default_rng(n_out2)
    t1 = np.where(rng.standard_normal(spec_t.q) > 0, 1.0, -1.0).astype(np.float32)
    alpha = rng.random(spec_t.n_alpha).astype(np.float32) + 0.1
    w2 = rng.standard_normal((n_out2, n_out1)).astype(np.float32)
    x = rng.standard_normal((4, n_in)).astype(np.float32)
    _close(collapse.fold_consumer_weight(torch.from_numpy(w2), torch.from_numpy(alpha),
                                         spec_t).numpy(),
           j_collapse.fold_consumer_weight(jnp.asarray(w2), jnp.asarray(alpha), spec_j))
    got = collapse.collapsed_chain_reference(
        torch.from_numpy(x), torch.from_numpy(t1), torch.from_numpy(alpha), spec_t,
        torch.from_numpy(w2))
    _close(got.numpy(), j_collapse.collapsed_chain_reference(
        jnp.asarray(x), jnp.asarray(t1), jnp.asarray(alpha), spec_j, jnp.asarray(w2)))
    # the collapse is the replicated chain: relu(x @ W1_hat^T) @ W2^T
    w1 = tiling.reconstruct_from_tile(torch.from_numpy(t1), torch.from_numpy(alpha),
                                      spec_t)
    _close(got.numpy(), (torch.relu(torch.from_numpy(x) @ w1.T)
                         @ torch.from_numpy(w2).T).numpy())


# ---------------------------------------------------------------------------
# param_count and abstract_params
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(J_ARCH_IDS))
def test_param_count_and_abstract_params_match_reference(arch):
    cfg, cj = get_config(arch).reduced(), j_get_config(arch).reduced()
    tm = build_model(cfg, ModelContext(policy=cfg.tbn, mode=TRAIN, device="meta"))
    jm = j_build_model(cj, JModelContext(policy=cj.tbn, mode=J_TRAIN))
    assert mod.param_count(tm.specs()) == j_mod.param_count(jm.specs())
    got = {"/".join(p): v for p, v in mod.walk(tm.abstract())}
    want = {"/".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in jax.tree_util.tree_leaves_with_path(jm.abstract())}
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.device.type == "meta" and tuple(v.shape) == tuple(want[k].shape), k
        assert str(v.dtype).split(".")[-1] == str(want[k].dtype), k
