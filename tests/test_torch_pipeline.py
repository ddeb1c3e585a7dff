"""GPipe over a 4-stage ("stage",) mesh of gloo ranks on the CPU
(``distributed/pipeline.py``), against the JAX package: the reference
test's shapes (S 4, M 8, MB 2, D 16), outputs equal to JAX's stages run in
sequence (rtol 2e-4, atol 2e-5), and the gradient of sum(y^2) by every
stage's weight equal to ``jax.grad`` of the sequential loss (rtol 5e-4,
atol 5e-5), as DESIGN.md §5 states the pipeline's semantics.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.distributed.pipeline import bubble_fraction
from torch_mesh_worker import finish_job, start_job

S, M, MB, D = 4, 8, 2, 16


@functools.lru_cache(maxsize=None)
def _inputs():
    ks = jax.random.split(jax.random.PRNGKey(0), S)
    ws = np.asarray(jnp.stack([jax.random.normal(k, (D, D)) * 0.3 for k in ks]))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(9), (M, MB, D)))
    return ws, x


@functools.lru_cache(maxsize=None)
def _ranks(tmp_root):
    from pathlib import Path

    ws, x = _inputs()
    case = dict(kind="gpipe", Ws=ws, x=x, meshes=[(S, 1)])
    job = start_job({"device": "cpu", "meshes": [(S, 1)], "cases": [case]}, S,
                    Path(tmp_root) / "gpipe")
    return [r[(0, (S, 1))] for r in finish_job(job, timeout=120)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return _ranks(str(tmp_path_factory.mktemp("gpipe")))


def _sequential(ws, x):
    h = x
    for s in range(S):
        h = jnp.tanh(h @ ws[s])
    return h


def test_pipeline_matches_sequential(ranks):
    ws, x = _inputs()
    want = np.asarray(_sequential(jnp.asarray(ws), jnp.asarray(x)))
    for r in ranks:
        np.testing.assert_allclose(r["y"].numpy(), want, rtol=2e-4, atol=2e-5)


def test_pipeline_gradient_is_the_sequential_losss(ranks):
    ws, x = _inputs()
    want = np.asarray(jax.grad(lambda w: jnp.sum(_sequential(w, jnp.asarray(x)) ** 2))(
        jnp.asarray(ws)))
    for r in ranks:
        np.testing.assert_allclose(r["grad"].numpy(), want, rtol=5e-4, atol=5e-5)


def test_bubble_fraction():
    assert abs(bubble_fraction(8, 4) - 3 / 11) < 1e-9
    assert bubble_fraction(1, 1) == 0.0
