"""Port parity for the paper's models (``models/paper.py``): TRAIN and SERVE
logits against the JAX package on the same numpy masters and inputs, the
exported words, the bit-width ledger of the paper's tables, and the
no-dense-weight guarantee of the tiled conv serve path.

Sizes are cut (narrow widths, small inputs, lambda lowered so that the
stages under test tile); the ResNet-34 ImageNet case keeps the 7x7 stride-2
stem, the SAME max pool and an even input (64) so every asymmetric SAME pad
is exercised. Tolerance: f32 logits within rtol = 1e-4, atol = 1e-4 *
max|logit| (sums reorder in the convs, LayerNorm and attention; the
structured JAX conv and the port's kernel-order sums differ by f32
rounding only). Exported words are equal; alphas within rtol 1e-5 (an f32
mean over up to ~1e5 weights, summed in another order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core.policy import bwnn_policy as j_bwnn_policy
from repro.core.policy import fp32_policy as j_fp32_policy
from repro.core.policy import tbn_policy as j_tbn_policy
from repro.models.paper import build_paper_model as j_build_paper_model
from repro.nn import module as j_mod
from repro.nn.context import SERVE as J_SERVE
from repro.nn.context import TRAIN as J_TRAIN
from repro.nn.context import ModelContext as JModelContext
from repro.serve.weights import export_serving_params as j_export
from repro_torch.core.policy import bwnn_policy, fp32_policy, tbn_policy
from repro_torch.device import NoCudaDeviceError
from repro_torch.models.paper import build_paper_model
from repro_torch.nn import module as mod
from repro_torch.nn.context import SERVE, TRAIN, ModelContext
from repro_torch.nn.linear import Conv2D
from repro_torch.serve.weights import (
    export_serving_params,
    params_from_numpy,
    serving_bytes,
)

torch.set_num_threads(2)
RTOL = 1e-4
ALPHA_RTOL = 1e-5

# name -> (builder, kwargs, policy (kind, p, lambda), input shape, serves)
CASES = {
    "resnet18-cifar": ("resnet18", dict(width=16), ("tbn", 4, 2000),
                       (2, 32, 32, 3), True),
    "resnet18-bwnn": ("resnet18", dict(width=16), ("bwnn", 1, 0),
                      (2, 16, 16, 3), True),
    "resnet18-fp32": ("resnet18", dict(width=16), ("fp32", 1, 0),
                      (2, 16, 16, 3), True),
    "resnet34-imagenet": ("resnet34", dict(width=8, imagenet=True, classes=1000),
                          ("tbn", 2, 2000), (2, 64, 64, 3), True),
    "resnet50": ("resnet50", dict(width=8), ("tbn", 4, 1000), (2, 32, 32, 3),
                 True),
    "vgg-small": ("vgg-small", {}, ("tbn", 4, 64_000), (2, 32, 32, 3), True),
    "vit": ("vit", dict(dim=64, depth=2, heads=4, mlp_dim=128, patch=4, img=16),
            ("tbn", 4, 2000), (2, 16, 16, 3), True),
    "pointnet-cls": ("pointnet", dict(task="cls", classes=5,
                                      widths=(16, 16, 32, 32, 64)),
                     ("tbn", 4, 4000), (2, 24, 3), True),
    "pointnet-part": ("pointnet", dict(task="part", classes=6,
                                       widths=(16, 16, 32, 32, 64)),
                      ("tbn", 4, 4000), (2, 24, 3), True),
    "pointnet-sem": ("pointnet", dict(task="sem", classes=4,
                                      widths=(16, 16, 32, 32, 64)),
                     ("tbn", 4, 4000), (2, 24, 3), True),
    "ts-transformer": ("ts-transformer", dict(features=7, dim=32, depth=2,
                                              heads=4, d_ff=64, horizon=2),
                       ("tbn", 4, 1000), (2, 12, 7), True),
    "mlpmixer": ("mlpmixer", dict(dim=64, depth=2, patch=4, img=16,
                                  token_hidden=32, chan_hidden=64),
                 ("tbn", 4, 2000), (2, 16, 16, 3), True),
    "swin-lite": ("swin-lite", dict(img=16, dims=(32, 64), depths=(1, 1),
                                    patch=2), ("tbn", 4, 2000), (2, 16, 16, 3),
                  True),
    "mcu-mlp": ("mcu-mlp", {}, ("tbn", 4, 64_000), (3, 784), True),
    "convmixer": ("convmixer", dict(dim=32, depth=2, kernel=4, patch=2, img=16),
                  ("tbn", 4, 3000), (2, 16, 16, 3), False),
}


def _policy(kind, p, lam, jax_side):
    if kind == "fp32":
        return j_fp32_policy() if jax_side else fp32_policy()
    if kind == "bwnn":
        return j_bwnn_policy() if jax_side else bwnn_policy()
    fn = j_tbn_policy if jax_side else tbn_policy
    return fn(p=p, min_size=lam, alpha_source="A", alpha_mode="tile")


def _jctx(pol, mode):
    return JModelContext(policy=pol, mode=mode, compute_dtype=jnp.float32,
                         use_pallas=False)


def _tctx(pol, mode):
    return ModelContext(policy=pol, mode=mode, compute_dtype=torch.float32,
                        device="cpu")


@functools.lru_cache(maxsize=None)
def _case(name):
    """Both packages' TRAIN / SERVE models, masters, exports and input."""
    builder, kw, (kind, p, lam), xshape, serves = CASES[name]
    pol_j, pol_t = _policy(kind, p, lam, True), _policy(kind, p, lam, False)
    tm_j = j_build_paper_model(builder, _jctx(pol_j, J_TRAIN), **kw)
    tm_t = build_paper_model(builder, _tctx(pol_t, TRAIN), **kw)
    masters = jax.tree.map(np.asarray, j_mod.init_params(
        tm_j.specs(), jax.random.PRNGKey(sum(map(ord, name)))))
    x = np.random.default_rng(len(name)).standard_normal(xshape).astype(np.float32)
    out = dict(tm_j=tm_j, tm_t=tm_t, masters=masters, x=x,
               tp_t=params_from_numpy(masters, "cpu"))
    if serves:
        sm_j = j_build_paper_model(builder, _jctx(pol_j, J_SERVE), **kw)
        sm_t = build_paper_model(builder, _tctx(pol_t, SERVE), **kw)
        out.update(sm_j=sm_j, sm_t=sm_t,
                   sp_j=j_export(tm_j.specs(), sm_j.specs(), masters, pol_j),
                   sp_t=export_serving_params(tm_t.specs(), sm_t.specs(),
                                              out["tp_t"], pol_t))
    return out


def _close_logits(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(want).all()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()))


def _leaves(tree):
    return {"/".join(p): v for p, v in mod.walk(tree)}


@pytest.mark.parametrize("name", list(CASES))
def test_train_logits_match_reference(name):
    c = _case(name)
    want = jax.jit(c["tm_j"].__call__)(c["masters"], c["x"])
    with torch.no_grad():
        got = c["tm_t"](c["tp_t"], torch.from_numpy(c["x"]))
    _close_logits(got, want)


@pytest.mark.parametrize("name", [n for n, v in CASES.items() if v[4]])
def test_serve_export_and_logits_match_reference(name):
    c = _case(name)
    sp_t = _leaves(c["sp_t"])
    sp_j = _leaves(jax.tree.map(np.asarray, c["sp_j"]))
    assert set(sp_t) == set(sp_j) == set(_leaves(c["sm_t"].specs()))
    for path, want in sp_j.items():
        got = sp_t[path].numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, path
        if want.dtype == np.int32:
            np.testing.assert_array_equal(got, want, err_msg=path)
        else:
            np.testing.assert_allclose(got, want, rtol=ALPHA_RTOL, atol=0,
                                       err_msg=path)
    want = jax.jit(c["sm_j"].__call__)(c["sp_j"], c["x"])
    with torch.no_grad():
        got = c["sm_t"](c["sp_t"], torch.from_numpy(c["x"]))
    _close_logits(got, want)


def test_resnet34_imagenet_serve_tree_has_every_form():
    """At the cut size the ResNet-34 ImageNet case tiles 3x3 convs, a 1x1
    stride-2 downsample and the head, and keeps the stem BWNN: every SERVE
    form the full-width model ships, under the reference's dotted keys."""
    sp = _case("resnet34-imagenet")["sp_t"]
    assert set(sp["stem"]) == {"wbits", "alpha"}
    assert sp["s1b0.c1"]["wbits"].shape == (16, 3)      # 8*9 = 72 bits
    assert sp["s2b0.c2"]["tile_conv"].shape == (9, 16, 1)
    assert sp["s3b0.down"]["tile_conv"].shape == (1, 32, 1)
    assert sp["s3b2.c2"]["tile_conv"].shape == (9, 32, 2)
    assert sp["head"]["tile"].shape == (500, 2)
    back = params_from_numpy({k: {kk: vv.numpy() for kk, vv in v.items()}
                              for k, v in sp.items()}, "cpu")
    assert _leaves(back).keys() == _leaves(sp).keys()
    assert serving_bytes(back) == serving_bytes(sp)


# --------------------------------------------------------------------------
# the ledger of the paper's tables
# --------------------------------------------------------------------------
LEDGER_CASES = [(m, {}, p, 64_000) for m in ("resnet18", "resnet50", "vgg-small")
                for p in (4, 8, 16)] + [
    ("resnet34", dict(imagenet=True, classes=1000), 2, 150_000),
    ("vit", {}, 4, 64_000), ("pointnet", {}, 4, 64_000),
    ("ts-transformer", {}, 4, 64_000), ("mcu-mlp", {}, 4, 64_000)]


@pytest.mark.parametrize("model,kw,p,lam", LEDGER_CASES)
def test_ledger_report_matches_reference(model, kw, p, lam):
    reports = []
    for jax_side in (True, False):
        pol = _policy("tbn", p, lam, jax_side)
        if jax_side:
            ctx = JModelContext(policy=pol, compute_dtype=jnp.float32)
            j_build_paper_model(model, ctx, **kw)
        else:
            ctx = ModelContext(policy=pol, compute_dtype=torch.float32,
                               device="cpu")
            build_paper_model(model, ctx, **kw)
        reports.append(ctx.ledger.report())
    want, got = reports
    assert got.summary(model) == want.summary(model)
    assert got.rows() == want.rows()
    assert got.total_bits() == want.total_bits()


def test_resnet34_imagenet_table1_row():
    """Table 1's ImageNet row: ResNet-34, p = 2, lambda = 150k, alpha per
    tile from A (the paper gives 11.13 Mbit, 0.53 bits/param)."""
    ctx = ModelContext(policy=tbn_policy(p=2, min_size=150_000,
                                         alpha_source="A", alpha_mode="tile"),
                       device="cpu")
    build_paper_model("resnet34", ctx, imagenet=True, classes=1000)
    rep = ctx.ledger.report()
    assert rep.universe_params == 21_779_648
    assert round(rep.mbit(), 3) == 11.646
    assert round(rep.bits_per_param(), 4) == 0.5347
    tiled = [r for r in rep.layers if r.spec is not None]
    assert [r.kind for r in tiled].count("conv") == 18
    assert [r.name for r in tiled if r.kind == "head"] == ["head"]


# --------------------------------------------------------------------------
# the serve path never rebuilds a tiled conv's dense weight
# --------------------------------------------------------------------------
class _ShapeLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.shapes.append((str(func), tuple(t.shape)))
        return out


def test_conv2d_serve_never_materializes_dense_weight():
    """Every intermediate of a tiled Conv2D's SERVE forward is recorded:
    none has the dense weight's shape or element count; the largest
    weight-derived tensor is one kernel position's (r, C) cross-section."""
    pol = tbn_policy(p=4, min_size=0, alpha_source="W")
    kw = dict(c_in=32, c_out=64, kernel=(3, 3))
    tc = Conv2D(ctx=_tctx(pol, TRAIN), **kw)
    sc = Conv2D(ctx=_tctx(pol, SERVE), **kw)
    tp = mod.init_params(tc.specs(), 0, "cpu")
    sp = export_serving_params(tc.specs(), sc.specs(), tp, pol)
    assert set(sp) == {"tile_conv", "alpha"}
    x = torch.randn((1, 8, 8, 32))
    n_dense = 64 * 32 * 3 * 3
    log = _ShapeLog()
    with torch.no_grad(), log:
        y = sc(sp, x)
    assert log.shapes, "the dispatch log recorded nothing"
    for op, shape in log.shapes:
        assert shape != (64, 32, 3, 3) and int(np.prod(shape)) != n_dense, \
            f"dense-weight-sized intermediate {shape} from {op}"
    with torch.no_grad():
        np.testing.assert_allclose(y.numpy(), tc(tp, x).numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_paper_models_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pol = tbn_policy(p=2, min_size=150_000)
    for mode in (TRAIN, SERVE):
        with pytest.raises(NoCudaDeviceError):
            build_paper_model("resnet34", ModelContext(policy=pol, mode=mode),
                              imagenet=True, classes=1000)
    model = build_paper_model("resnet18", _tctx(pol, SERVE), width=8)
    assert all(v.device.type == "cpu" for _, v in mod.walk(model.init(0)))
