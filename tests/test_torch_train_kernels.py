"""Port parity of the training-time layer math against the JAX package, on
the same numpy inputs, f32: kernel B5's plain version and ``tile_construct``
(words exactly equal, alpha to rtol 1e-6), ``tbn_dense_train`` forward and
gradients, ``tiled_weight`` / ``tiled_weight_rows`` gradients under both
STE modes, every TRAIN branch of ``Dense``, and the training attention
call, full and query-chunked."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy as j_policy
from repro.core import tiling as j_tiling
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.kernels.tile_construct import tile_construct_pallas
from repro.nn import module as j_mod
from repro.nn.attention import Attention as JAttention
from repro.nn.context import TRAIN as J_TRAIN
from repro.nn.context import ModelContext as JModelContext
from repro.nn.linear import Dense as JDense
from repro_torch.core import policy
from repro_torch.core import tiling
from repro_torch.kernels import ops, ref
from repro_torch.kernels.tile_construct import tile_construct_kernel
from repro_torch.nn import module as mod
from repro_torch.nn.attention import Attention
from repro_torch.nn.context import TRAIN, ModelContext
from repro_torch.nn.linear import Dense
from repro_torch.serve.weights import params_from_numpy

torch.set_num_threads(2)
RTOL = 1e-5


def _close(got, want, **kw):
    """rtol 1e-5 with atol 1e-5 * max|want|: f32 sums in another order
    leave absolute errors near that size on entries near zero."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()), **kw)


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _grads_torch(fn, *arrays):
    """(value, grads) of fn(*tensors) for numpy inputs."""
    ts = [_t(a).requires_grad_() for a in arrays]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, allow_unused=True, materialize_grads=True)
    return out.detach().numpy(), [g.numpy() for g in grads]


# --------------------------------------------------------------------------
# B5: the plain version and tile_construct
# --------------------------------------------------------------------------
@pytest.mark.parametrize("source", ["W", "A"])
@pytest.mark.parametrize("p,q", [(2, 64), (4, 128), (8, 4096), (4, 8192), (3, 96)])
def test_b5_plain_matches_pallas_interpret_and_ref(p, q, source):
    w = _np(p * q, p, q)
    a = _np(p * q + 1, p, q) if source == "A" else None
    want_k = tile_construct_pallas(jnp.asarray(w), None if a is None else jnp.asarray(a),
                                   block_q=min(1024, q), interpret=True)
    want_r = j_ref.tile_construct_ref(jnp.asarray(w), None if a is None else jnp.asarray(a))
    got_k = tile_construct_kernel(_t(w), None if a is None else _t(a))
    got_r = ref.tile_construct_ref(_t(w), None if a is None else _t(a))
    for got in (got_k, got_r):
        for want in (want_k, want_r):
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
            np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)


@pytest.mark.parametrize("alpha_source", ["W", "A"])
@pytest.mark.parametrize("alpha_mode", ["layer", "tile"])
@pytest.mark.parametrize("shape", [(40, 50), (64, 48)])
def test_tile_construct_matches_reference_both_branches(shape, alpha_mode, alpha_source):
    """(40, 50): q = 500 is padded to 512 and alpha rescaled."""
    kw = dict(p=4, min_size=1, alpha_mode=alpha_mode, alpha_source=alpha_source)
    spec_j, spec = j_tiling.plan_tiling(shape, **kw), tiling.plan_tiling(shape, **kw)
    w, a = _np(3, *shape), _np(4, *shape)
    got = ops.tile_construct(_t(w), spec, a=_t(a))
    for use_pallas in (False, True):
        want = j_ops.tile_construct(jnp.asarray(w), spec_j, a=jnp.asarray(a),
                                    use_pallas=use_pallas)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)
        assert got[1].shape == want[1].shape


def test_b5_plain_sums_in_fixed_order():
    """A column whose sum is +tiny in row order 0..p-1 and 0 in another
    order: the plain version's bit follows the fixed order."""
    w = torch.tensor([[1e8], [1.0], [-1e8], [0.0]]).expand(4, 32).contiguous()
    packed, _ = tile_construct_kernel(w)
    s = ((w[0] + w[1]) + w[2]) + w[3]
    assert float(s[0]) == 0.0 and int(packed[0]) == 0
    w2 = torch.tensor([[1e8], [-1e8], [1.0], [0.0]]).expand(4, 32).contiguous()
    assert int(tile_construct_kernel(w2)[0][0]) == -1       # all 32 bits set


def test_b5_wrapper_checks_operands():
    with pytest.raises(ValueError, match="multiple of 32"):
        tile_construct_kernel(torch.zeros(4, 50))
    with pytest.raises(TypeError):
        tile_construct_kernel(torch.zeros(4, 64, dtype=torch.float64))
    with pytest.raises(ValueError, match="a2d"):
        tile_construct_kernel(torch.zeros(4, 64), torch.zeros(4, 32))
    with pytest.raises(ValueError, match="no kernel"):
        tile_construct_kernel(torch.zeros(4, 64, device="meta"))


# --------------------------------------------------------------------------
# tbn_dense_train
# --------------------------------------------------------------------------
@pytest.mark.parametrize("alpha_source", ["W", "A"])
@pytest.mark.parametrize("alpha_mode", ["layer", "tile"])
@pytest.mark.parametrize("xshape", [(10, 48), (2, 5, 48)])
def test_tbn_dense_train_forward_and_grads_match_jax(xshape, alpha_mode, alpha_source):
    kw = dict(p=4, min_size=1, alpha_mode=alpha_mode, alpha_source=alpha_source)
    spec_j, spec = j_tiling.plan_tiling((64, 48), **kw), tiling.plan_tiling((64, 48), **kw)
    x, w = _np(6, *xshape), _np(7, 64, 48)
    a = _np(8, 64, 48) if alpha_source == "A" else w
    g = _np(9, *xshape[:-1], 64)
    y_j, vjp = jax.vjp(lambda x, w, a: j_ops.tbn_dense_train(x, w, a, spec_j),
                       jnp.asarray(x), jnp.asarray(w), jnp.asarray(a))
    want = vjp(jnp.asarray(g))
    if alpha_source == "W":
        y, grads = _grads_torch(
            lambda x, w: (ops.tbn_dense_train(x, w, w, spec) * _t(g)).sum(), x, w)
        want = (want[0], want[1] + want[2])      # a is w: the two sum into w
    else:
        y, grads = _grads_torch(
            lambda x, w, a: (ops.tbn_dense_train(x, w, a, spec) * _t(g)).sum(), x, w, a)
    y_t = ops.tbn_dense_train(_t(x), _t(w), _t(a), spec)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5)
    for got, w_ in zip(grads, want):
        _close(got, np.asarray(w_))


# --------------------------------------------------------------------------
# tiled_weight / tiled_weight_rows and the STE
# --------------------------------------------------------------------------
@pytest.mark.parametrize("ste", ["identity", "autodiff"])
@pytest.mark.parametrize("alpha_mode", ["layer", "tile"])
@pytest.mark.parametrize("alpha_source", ["W", "A"])
@pytest.mark.parametrize("shape", [(32, 24), (30, 16)])
def test_tiled_weight_grads_match_jax(shape, alpha_source, alpha_mode, ste):
    """(30, 16) with p = 4 is unaligned: only the flat construction."""
    kw = dict(p=4, min_size=1, alpha_mode=alpha_mode, alpha_source=alpha_source, ste=ste)
    spec_j, spec = j_tiling.plan_tiling(shape, **kw), tiling.plan_tiling(shape, **kw)
    w, a, g = _np(11, *shape), _np(12, *shape), _np(13, *shape)
    fns = [(j_tiling.tiled_weight, tiling.tiled_weight)]
    if spec.aligned_rows and ste == "identity":
        fns.append((j_tiling.tiled_weight_rows, tiling.tiled_weight_rows))
    for jf, tf in fns:
        val_j, grads_j = jax.value_and_grad(
            lambda w, a: (jf(w, spec_j, a=a) * g).sum(), argnums=(0, 1))(
                jnp.asarray(w), jnp.asarray(a))
        val, grads = _grads_torch(lambda w, a: (tf(w, spec, a=a) * _t(g)).sum(), w, a)
        np.testing.assert_allclose(val, np.asarray(val_j), rtol=1e-5)
        for got, want in zip(grads, grads_j):
            _close(got, np.asarray(want))


def test_tiled_weight_rows_with_lead_dims_matches_jax():
    spec_j = j_tiling.plan_tiling((32, 24), p=4, min_size=1, alpha_source="W")
    spec = tiling.plan_tiling((32, 24), p=4, min_size=1, alpha_source="W")
    w, g = _np(14, 3, 32, 24), _np(15, 3, 32, 24)
    want, gw = jax.value_and_grad(
        lambda w: (j_tiling.tiled_weight_rows(w, spec_j) * g).sum())(jnp.asarray(w))
    got, (gw_t,) = _grads_torch(lambda w: (tiling.tiled_weight_rows(w, spec) * _t(g)).sum(), w)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5)
    _close(gw_t, np.asarray(gw))


def test_export_tile_matches_jax_and_has_no_grad():
    spec_j = j_tiling.plan_tiling((32, 24), p=4, min_size=1, alpha_source="A")
    spec = tiling.plan_tiling((32, 24), p=4, min_size=1, alpha_source="A")
    w, a = _np(16, 32, 24), _np(17, 32, 24)
    t_j, al_j = j_tiling.export_tile(jnp.asarray(w), spec_j, a=jnp.asarray(a))
    t, al = tiling.export_tile(_t(w).requires_grad_(), spec, a=_t(a).requires_grad_())
    np.testing.assert_array_equal(t.numpy(), np.asarray(t_j))
    np.testing.assert_allclose(al.numpy(), np.asarray(al_j), rtol=1e-6)
    assert not (t.requires_grad or al.requires_grad)


def test_construct_binary_checks_shape():
    spec = tiling.plan_tiling((32, 24), p=4, min_size=1)
    with pytest.raises(ValueError, match="spec shape"):
        tiling.construct_binary(torch.zeros(24, 32), spec)


# --------------------------------------------------------------------------
# Dense TRAIN branches
# --------------------------------------------------------------------------
def _policies(name):
    """(JAX policy, port policy, fused_train) per Dense TRAIN branch."""
    tbn = dict(p=4, min_size=1, alpha_source="W", alpha_mode="tile")
    return {
        "fused": (j_policy.tbn_policy(**tbn), policy.tbn_policy(**tbn), True),
        "rows": (j_policy.tbn_policy(**tbn), policy.tbn_policy(**tbn), False),
        "rows_alpha_A": (j_policy.tbn_policy(**dict(tbn, alpha_source="A")),
                         policy.tbn_policy(**dict(tbn, alpha_source="A")), False),
        "unaligned": (j_policy.tbn_policy(**tbn, require_aligned=False),
                      policy.tbn_policy(**tbn, require_aligned=False), False),
        "bwnn": (j_policy.bwnn_policy(), policy.bwnn_policy(), False),
        "fp32": (j_policy.fp32_policy(), policy.fp32_policy(), False),
    }[name]


@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("branch", ["fused", "rows", "rows_alpha_A", "unaligned",
                                    "bwnn", "fp32"])
def test_dense_train_branches_match_jax(branch, use_bias):
    pol_j, pol, fused = _policies(branch)
    n_out = 30 if branch == "unaligned" else 32
    jd = JDense(16, n_out, JModelContext(policy=pol_j, mode=J_TRAIN,
                                         compute_dtype=jnp.float32,
                                         fused_train=fused), use_bias=use_bias)
    td = Dense(16, n_out, ModelContext(policy=pol, mode=TRAIN,
                                       compute_dtype=torch.float32, device="cpu",
                                       fused_train=fused), use_bias=use_bias)
    assert (td.spec is None) == (jd.spec is None)
    if branch == "unaligned":
        assert not td.spec.aligned_rows
    params_j = j_mod.init_params(jd.specs(), jax.random.PRNGKey(1))
    params_j = jax.tree.map(lambda v: v + 0.1, params_j)     # nonzero bias
    x, g = _np(20, 3, 16), _np(21, 3, n_out)
    val_j, grads_j = jax.value_and_grad(
        lambda p, x: (jd(p, x) * g).sum(), argnums=(0, 1))(params_j, jnp.asarray(x))
    params = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    paths, leaves = zip(*mod.walk(params))
    xt = _t(x).requires_grad_()
    for v in leaves:
        v.requires_grad_()
    val = (td(params, xt) * _t(g)).sum()
    grads = torch.autograd.grad(val, [xt, *leaves])
    np.testing.assert_allclose(float(val.detach()), float(val_j), rtol=1e-5)
    _close(grads[0].numpy(), np.asarray(grads_j[1]))
    for path, got in zip(paths, grads[1:]):
        want = grads_j[0]
        for k in path:
            want = want[k]
        _close(got.numpy(), want, err_msg="/".join(path))


# --------------------------------------------------------------------------
# Attention, training call
# --------------------------------------------------------------------------
@pytest.mark.parametrize("chunked", [False, True])
def test_attention_call_matches_jax(chunked):
    """S = 32 with q_chunk = 8: the default rule chunks (S >= 4 * q_chunk)."""
    pol_j, pol, _ = _policies("rows")
    ja = JAttention(32, 4, 2, JModelContext(policy=pol_j, mode=J_TRAIN,
                                             compute_dtype=jnp.float32),
                    head_dim=8, q_chunk=8)
    ta = Attention(32, 4, 2, ModelContext(policy=pol, mode=TRAIN,
                                          compute_dtype=torch.float32, device="cpu"),
                   head_dim=8, q_chunk=8)
    params_j = j_mod.init_params(ja.specs(), jax.random.PRNGKey(2))
    x, g = _np(22, 2, 32, 32), _np(23, 2, 32, 32)
    val_j, grads_j = jax.value_and_grad(
        lambda p, x: (ja(p, x, chunked=chunked) * g).sum(), argnums=(0, 1))(
            params_j, jnp.asarray(x))
    params = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    paths, leaves = zip(*mod.walk(params))
    xt = _t(x).requires_grad_()
    for v in leaves:
        v.requires_grad_()
    out = ta(params, xt, chunked=chunked)
    if chunked:
        np.testing.assert_allclose(out.detach().numpy(),
                                   ta(params, xt, chunked=False).detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
    val = (out * _t(g)).sum()
    grads = torch.autograd.grad(val, [xt, *leaves])
    np.testing.assert_allclose(float(val.detach()), float(val_j), rtol=1e-5)
    _close(grads[0].numpy(), np.asarray(grads_j[1]))
    for path, got in zip(paths, grads[1:]):
        want = grads_j[0]
        for k in path:
            want = want[k]
        _close(got.numpy(), np.asarray(want))


def test_attention_default_chunking_rule():
    ta = Attention(32, 4, 2, ModelContext(policy=policy.fp32_policy(), mode=TRAIN,
                                          compute_dtype=torch.float32, device="cpu"),
                   head_dim=8, q_chunk=8)
    params = mod.init_params(ta.specs(), 0, "cpu")
    calls = []
    orig = ta._chunked
    ta._chunked = lambda *a: calls.append(1) or orig(*a)
    ta(params, torch.randn(1, 31, 32))
    assert not calls
    ta(params, torch.randn(1, 32, 32))
    assert calls


def test_remat_modes():
    from repro_torch.configs import build_model, get_config

    cfg = get_config("granite-8b").reduced()
    tokens = {"tokens": torch.randint(0, cfg.vocab, (2, 8),
                                      generator=torch.Generator().manual_seed(0))}
    losses = []
    for remat in ("full", "none"):
        m = build_model(dataclasses.replace(cfg, remat=remat),
                        ModelContext(policy=cfg.tbn, mode=TRAIN, device="cpu",
                                     compute_dtype=torch.float32))
        losses.append(float(m.train_forward(m.init(0), tokens)[0]))
    assert losses[0] == losses[1]
    m = build_model(dataclasses.replace(cfg, remat="dots"),
                    ModelContext(policy=cfg.tbn, mode=TRAIN, device="cpu"))
    with pytest.raises(NotImplementedError, match="item 10"):
        m.train_forward(m.init(0), tokens)
