"""``remat="dots"``: a selective checkpoint that saves the matrix products'
outputs (aten's, and kernels B1 / B2 as operators) and recomputes the rest
(``distributed.sharding.dots_policy``; the reference's
``jax.checkpoint_policies.checkpoint_dots``).

* On the CPU the loss and every gradient equal "full"'s and "none"'s
  exactly (the same ops run, only their storage differs), fused and not,
  dense and MoE; the encoder-decoder checkpoints whole layers under
  "dots", as the reference does.
* The loss and every gradient match the JAX package's "dots" step within
  rtol 1e-4 (f32; atol 1e-4 * max|g| per leaf).
* A dots-checkpointed region that calls B1 and B2 runs each once (their
  saved outputs serve the recompute), where a full checkpoint runs them
  twice; B5 (not a product) runs twice under both.
"""
import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build_model as j_build_model
from repro.configs import get_config as j_get_config
from repro.nn import module as j_mod
from repro.nn.context import TRAIN as J_TRAIN
from repro.nn.context import ModelContext as JModelContext
from repro_torch.configs import build_model, get_config
from repro_torch.distributed.sharding import dots_policy, remat
from repro_torch.kernels.ops import tile_construct
from repro_torch.kernels.tiled_matmul import tiled_matmul_unique
from repro_torch.kernels.tiled_matvec import tiled_matvec_unique
from repro_torch.nn import module as mod
from repro_torch.nn.context import TRAIN, ModelContext
from repro_torch.serve.weights import params_from_numpy

torch.set_num_threads(2)
RTOL = 1e-4


def _tokens(cfg, b=2, s=16):
    return np.random.default_rng(3).integers(0, cfg.vocab, (b, s)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _masters(arch):
    cfg = j_get_config(arch).reduced()
    tm = j_build_model(cfg, JModelContext(policy=cfg.tbn, mode=J_TRAIN,
                                          compute_dtype=jnp.float32))
    return jax.tree.map(np.asarray, j_mod.init_params(tm.specs(),
                                                      jax.random.PRNGKey(1)))


def _port_grads(arch, remat_mode, fused, batch):
    cfg = dataclasses.replace(get_config(arch).reduced(), remat=remat_mode)
    model = build_model(cfg, ModelContext(policy=cfg.tbn, mode=TRAIN, device="cpu",
                                          compute_dtype=torch.float32,
                                          fused_train=fused))
    params = params_from_numpy(_masters(arch), "cpu")
    paths, leaves = zip(*mod.walk(params))
    for v in leaves:
        v.requires_grad_(True)
    loss, _ = model.train_forward(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss), dict(zip(("/".join(p) for p in paths), grads))


def _batch(arch):
    cfg = get_config(arch).reduced()
    if cfg.family == "encdec":
        rng = np.random.default_rng(4)
        return {"frames": torch.from_numpy(
                    0.1 * rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)),
                "tokens": torch.from_numpy(_tokens(cfg, 2, 4))}
    return {"tokens": torch.from_numpy(_tokens(cfg))}


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("arch", ["granite-8b", "qwen2-moe-a2.7b",
                                  "seamless-m4t-large-v2"])
def test_dots_equals_full_and_none_on_the_cpu(arch, fused):
    batch = _batch(arch)
    loss_d, g_d = _port_grads(arch, "dots", fused, batch)
    for other in ("full", "none"):
        loss_o, g_o = _port_grads(arch, other, fused, batch)
        assert loss_d == loss_o
        for k, g in g_d.items():
            assert torch.equal(g, g_o[k]), (other, k)


@pytest.mark.parametrize("arch", ["granite-8b", "qwen2-moe-a2.7b"])
def test_dots_matches_the_reference_dots_step(arch):
    cj = dataclasses.replace(j_get_config(arch).reduced(), remat="dots")
    tm = j_build_model(cj, JModelContext(policy=cj.tbn, mode=J_TRAIN,
                                         compute_dtype=jnp.float32))
    toks = _tokens(cj)
    (loss_j, _), g_j = jax.value_and_grad(tm.train_forward, has_aux=True)(
        jax.tree.map(jnp.asarray, _masters(arch)), {"tokens": jnp.asarray(toks)})
    loss_t, g_t = _port_grads(arch, "dots", True, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(loss_t, float(loss_j), rtol=RTOL)
    flat_j = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
              for path, v in jax.tree_util.tree_leaves_with_path(g_j)}
    assert set(flat_j) == set(g_t)
    for k, g in g_t.items():
        want = flat_j[k]
        np.testing.assert_allclose(g.numpy(), want, rtol=RTOL,
                                   atol=RTOL * float(np.abs(want).max()), err_msg=k)


def _plain_calls(fn):
    """(fn's result, {plain version: calls}) with B1 / B2 / B5's plain
    versions (their CPU operators) counted."""
    spots = [(importlib.import_module("repro_torch.kernels.tiled_matvec"),
              "tiled_matvec_plain"),
             (importlib.import_module("repro_torch.kernels.tiled_matmul"),
              "tiled_matmul_plain"),
             (importlib.import_module("repro_torch.kernels.tile_construct"),
              "tile_construct_plain")]
    counts = {}
    saved = [(m, n, getattr(m, n)) for m, n in spots]

    def counted(name, f):
        def run(*a, **kw):
            counts[name] = counts.get(name, 0) + 1
            return f(*a, **kw)
        return run

    for m, n, f in saved:
        setattr(m, n, counted(n, f))
    try:
        return fn(), counts
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


@pytest.mark.parametrize("policy,runs", [(None, 2), (dots_policy, 1)])
def test_dots_saves_the_kernel_products(policy, runs):
    """A region with B5, then B1 (m = 4) and B2 (m = 40) on its words, and a
    non-product op: under a full checkpoint every kernel runs again in the
    backward; under "dots" B1's and B2's outputs are saved (each runs
    once) and B5 is recomputed."""
    from repro_torch.core.tiling import plan_tiling

    gen = torch.Generator().manual_seed(0)
    w = torch.randn((64, 64), generator=gen)
    spec = plan_tiling((64, 64), p=4, min_size=1, alpha_source="W")

    x4 = torch.randn((4, 64), generator=gen)
    x40 = torch.randn((40, 64), generator=gen)

    def region(v):
        words, alpha = tile_construct(w, spec)
        rows = words.reshape(16, 2)
        u = torch.cat([tiled_matvec_unique(x4, rows),
                       tiled_matmul_unique(x40, rows)]) * alpha.sum()
        return torch.tanh(u * v).sum()

    v = torch.ones((), requires_grad=True)

    def step():
        # the kernels' outputs carry no gradient of their own (the fused
        # path's autograd functions give them theirs): v's gradient needs
        # tanh's recomputed inputs, and so the products
        y = remat(region, v, policy=policy)
        y.backward()
        return float(v.grad)

    loss, counts = _plain_calls(step)
    assert counts == {"tile_construct_plain": 2, "tiled_matvec_plain": runs,
                      "tiled_matmul_plain": runs}
    assert np.isfinite(loss)
