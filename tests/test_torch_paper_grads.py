"""Gradients of the paper's models (``models/paper.py``) against
``jax.grad`` of the JAX package's, for every case of
``tests/test_torch_paper.py``'s ``CASES`` (15 models and policies, the same
cut sizes): the same numpy masters and input as its logits test, the loss
sum(logits * c) for a fixed random c, every master's gradient within rtol
1e-4 and atol 1e-4 * max|g| of its leaf (f32; convs, norms and attention
reorder sums).

A ReLU whose input lands within rounding of 0 takes its kink's side by
that rounding, so a gradient can differ where the forward agrees: with
another input (``default_rng(len(name) + 1)``) resnet18-bwnn's
``s0b1.n1/bias`` differs by 2.2e-2 in one channel while its logits agree
to 1.7e-6, because one pre-activation downstream is ~1e-7 (the binary
weights' sums cancel).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.paper import build_paper_model as j_build_paper_model
from repro.nn import module as j_mod
from repro.nn.context import TRAIN as J_TRAIN
from repro_torch.models.paper import build_paper_model
from repro_torch.nn import module as mod
from repro_torch.nn.context import TRAIN
from repro_torch.serve.weights import params_from_numpy
from test_torch_paper import CASES, _jctx, _policy, _tctx

torch.set_num_threads(2)
RTOL = 1e-4


@functools.lru_cache(maxsize=None)
def _grads(name):
    builder, kw, (kind, p, lam), xshape, _ = CASES[name]
    tm_j = j_build_paper_model(builder, _jctx(_policy(kind, p, lam, True), J_TRAIN), **kw)
    tm_t = build_paper_model(builder, _tctx(_policy(kind, p, lam, False), TRAIN), **kw)
    masters = jax.tree.map(np.asarray, j_mod.init_params(
        tm_j.specs(), jax.random.PRNGKey(sum(map(ord, name)))))
    # the logits test's own input; the cotangent from another seed
    x = np.random.default_rng(len(name)).standard_normal(xshape).astype(np.float32)
    out_shape = jax.eval_shape(tm_j.__call__, masters, x).shape
    c = np.random.default_rng(len(name) + 1).standard_normal(out_shape).astype(np.float32)
    g_j = jax.jit(jax.grad(lambda prm: jnp.sum(tm_j(prm, x) * c)))(masters)
    params = params_from_numpy(masters, "cpu")
    paths, leaves = zip(*mod.walk(params))
    for v in leaves:
        v.requires_grad_(True)
    loss = (tm_t(params, torch.from_numpy(x)) * torch.from_numpy(c)).sum()
    g_t = torch.autograd.grad(loss, leaves, allow_unused=True)
    want = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(g_j)}
    got = {"/".join(p): (np.zeros(want["/".join(p)].shape, np.float32) if g is None
                         else g.numpy()) for p, g in zip(paths, g_t)}
    return got, want


@pytest.mark.parametrize("name", list(CASES))
def test_paper_model_gradients_match_jax_grad(name):
    got, want = _grads(name)
    assert set(got) == set(want)
    for k, g in got.items():
        w = want[k]
        assert np.isfinite(w).all()
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=RTOL * float(np.abs(w).max()), err_msg=k)
