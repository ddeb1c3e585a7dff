"""Port parity for the conv path: conv-layout packing, the padding rule,
``tiled_conv_infer`` (kernel B6's plain version on the CPU), ``Conv2D`` and
``Dense`` in every TRAIN and SERVE form, and their export.

The same numpy inputs go through the JAX package and the port. The JAX
conv is held through ``kernels.ref.tiled_conv_ref`` and its structured
path (``use_pallas=False``): the Pallas conv kernel's interpret mode does
not run on this jax (no ``pallas.load``). Tolerances: packed words are
equal, alpha within rtol 1e-6 (an f32 ``mean`` of the same values in
another order), float outputs within rtol = atol = 1e-4 in f32 (x * ±1 is
exact; only the order of the sums differs, as in the reference's own
conv tests).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pack_conv_tile as j_pack_conv_tile
from repro.core import unpack_conv_tile as j_unpack_conv_tile
from repro.core.policy import bwnn_policy as j_bwnn_policy
from repro.core.policy import fp32_policy as j_fp32_policy
from repro.core.policy import tbn_policy as j_tbn_policy
from repro.core.tiling import plan_tiling as j_plan_tiling
from repro.kernels import resolve_conv_padding as j_resolve_conv_padding
from repro.kernels import tiled_conv_infer as j_tiled_conv_infer
from repro.kernels.ref import tiled_conv_dense_weight as j_tiled_conv_dense_weight
from repro.kernels.ref import tiled_conv_ref as j_tiled_conv_ref
from repro.nn.context import SERVE as J_SERVE
from repro.nn.context import TRAIN as J_TRAIN
from repro.nn.context import ModelContext as JModelContext
from repro.nn.linear import Conv2D as JConv2D
from repro.nn.linear import Dense as JDense
from repro.serve.weights import export_serving_params as j_export
from repro.serve.weights import tile_serving_bytes as j_tile_serving_bytes
from repro_torch.core.packing import pack_bits, pack_conv_tile, unpack_conv_tile
from repro_torch.core.policy import bwnn_policy, fp32_policy, tbn_policy
from repro_torch.core.tiling import (
    conv_tile_bank,
    plan_conv_tiling,
    plan_tiling,
    tile_vector,
)
from repro_torch.kernels import ref
from repro_torch.kernels.ops import resolve_conv_padding, tiled_conv_infer
from repro_torch.kernels.tiled_conv import tiled_conv_plain, tiled_conv_unique
from repro_torch.nn.context import SERVE, TRAIN, ModelContext
from repro_torch.nn.linear import Conv2D, Dense
from repro_torch.serve.weights import (
    export_serving_params,
    tile_serving_bytes,
)

torch.set_num_threads(2)
RTOL = ATOL = 1e-4
ALPHA_RTOL = 1e-6


def _pm1(rng, shape):
    return np.where(rng.random(shape) < 0.5, 1.0, -1.0).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _case(c_out, c_in, kh, kw, p, alpha_mode="tile", seed=0):
    """A conv tile (numpy) for both packages: (spec_j, spec_t, packed,
    alpha), packed by the JAX package from a random ±1 tile."""
    shape = (c_out, c_in, kh, kw)
    kw_ = dict(p=p, min_size=0, alpha_mode=alpha_mode, alpha_source="W")
    spec_j, spec_t = j_plan_tiling(shape, **kw_), plan_tiling(shape, **kw_)
    assert spec_t.aligned_rows
    rng = np.random.default_rng(seed + c_out * kh + c_in)
    t = _pm1(rng, (spec_t.q,))
    packed = np.array(j_pack_conv_tile(jnp.asarray(t), c_out // p, c_in, kh, kw))
    alpha = (rng.random(spec_t.n_alpha) + 0.5).astype(np.float32)
    return spec_j, spec_t, packed, alpha


def _infer_both(spec_j, spec_t, packed, alpha, x, stride, padding):
    want = j_tiled_conv_ref(jnp.asarray(x), jnp.asarray(packed),
                            jnp.asarray(alpha), spec_j, stride=stride,
                            padding=padding)
    structured = j_tiled_conv_infer(jnp.asarray(x), jnp.asarray(packed),
                                    jnp.asarray(alpha), spec_j, stride=stride,
                                    padding=padding, use_pallas=False)
    got = tiled_conv_infer(torch.from_numpy(x), torch.from_numpy(packed),
                           torch.from_numpy(alpha), spec_t, stride=stride,
                           padding=padding)
    assert got.shape == want.shape == structured.shape
    assert got.dtype == torch.float32
    return got, want, structured


# --------------------------------------------------------------------------
# conv-layout packing
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kernel", [(3, 3), (1, 1), (5, 3)])
@pytest.mark.parametrize("c_in", [1, 3, 32, 48, 64])
def test_pack_conv_tile_bit_identical(c_in, kernel):
    r, (kh, kw) = 6, kernel
    t = _pm1(np.random.default_rng(c_in * kh + kw), (r * c_in * kh * kw,))
    want = np.asarray(j_pack_conv_tile(jnp.asarray(t), r, c_in, kh, kw))
    got = pack_conv_tile(torch.from_numpy(t), r, c_in, kh, kw)
    assert got.dtype == torch.int32 and got.shape == (kh * kw, r, -(-c_in // 32))
    np.testing.assert_array_equal(got.numpy(), want)
    bank = unpack_conv_tile(got, r, c_in, kh, kw)
    np.testing.assert_array_equal(
        bank.numpy(), np.asarray(j_unpack_conv_tile(jnp.asarray(want), r, c_in,
                                                    kh, kw)))
    np.testing.assert_array_equal(bank.numpy(), t.reshape(r, c_in, kh, kw))


def test_conv_plan_matches_reference():
    spec = plan_tiling((256, 128, 3, 3), p=2, min_size=150_000)
    plan = plan_conv_tiling(spec)
    assert (plan.c_out, plan.c_in, plan.kernel, plan.r, plan.kk, plan.positions) \
        == (256, 128, (3, 3), 128, 1152, 9)
    assert plan.packed_shape() == (9, 128, 4)
    assert plan_conv_tiling(None) is None
    assert plan_conv_tiling(plan_tiling((10, 4), p=2, min_size=0)) is None
    unaligned = plan_tiling((9, 4, 3, 3), p=2, min_size=0)
    assert not unaligned.aligned_rows and plan_conv_tiling(unaligned) is None
    t = torch.from_numpy(_pm1(np.random.default_rng(0), (spec.q,)))
    bank = conv_tile_bank(t, plan)
    assert bank.shape == (128, 128, 3, 3)
    np.testing.assert_array_equal(bank.numpy(), t.reshape(128, 128, 3, 3).numpy())


# --------------------------------------------------------------------------
# padding rule
# --------------------------------------------------------------------------
@pytest.mark.parametrize("padding", ["SAME", "SAME_LOWER", "VALID",
                                     [(1, 2), (0, 1)], [(2, 1), (0, 2)]])
@pytest.mark.parametrize("stride", [(1, 1), (2, 2), (3, 1), (1, 2)])
@pytest.mark.parametrize("hw,kernel", [((13, 9), (3, 3)), ((224, 224), (7, 7)),
                                       ((112, 112), (3, 3)), ((56, 56), (1, 1)),
                                       ((8, 7), (5, 3))])
def test_resolve_conv_padding_matches_reference(hw, kernel, stride, padding):
    assert resolve_conv_padding(hw, kernel, stride, padding) == \
        j_resolve_conv_padding(hw, kernel, stride, padding)


def test_same_is_asymmetric_as_in_the_reference():
    # the 7x7 s2 stem on 224 pads (2, 3); a 3x3 s2 on 56 pads (0, 1)
    assert resolve_conv_padding((224, 224), (7, 7), (2, 2), "SAME") == \
        ((112, 112), ((2, 3), (2, 3)))
    assert resolve_conv_padding((56, 56), (3, 3), (2, 2), "SAME") == \
        ((28, 28), ((0, 1), (0, 1)))
    with pytest.raises(ValueError, match="unsupported padding"):
        resolve_conv_padding((8, 8), (3, 3), (1, 1), "WRAP")


# --------------------------------------------------------------------------
# tiled_conv_infer against the reference's oracle and structured path
# --------------------------------------------------------------------------
@pytest.mark.parametrize("stride", [(1, 1), (2, 2)])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("kernel", [(1, 1), (3, 3)])
@pytest.mark.parametrize("c_in,c_out,p", [(32, 64, 4), (16, 24, 2), (3, 8, 2)])
def test_tiled_conv_infer_matches_reference(stride, padding, kernel, c_in,
                                            c_out, p):
    kh, kw = kernel
    spec_j, spec_t, packed, alpha = _case(c_out, c_in, kh, kw, p)
    x = np.random.default_rng(1).standard_normal((2, 10, 9, c_in)).astype(np.float32)
    got, want, structured = _infer_both(spec_j, spec_t, packed, alpha, x,
                                        stride, padding)
    _close(got, want)
    _close(got, structured)
    # the port's own dense oracle is the reference's
    mine = ref.tiled_conv_ref(torch.from_numpy(x), torch.from_numpy(packed),
                              torch.from_numpy(alpha), spec_t, stride=stride,
                              padding=padding)
    _close(mine, want)


@pytest.mark.parametrize("alpha_mode", ["layer", "tile"])
@pytest.mark.parametrize("kernel,stride", [((5, 3), (1, 2)), ((3, 3), (2, 1))])
def test_tiled_conv_infer_asymmetric_and_alpha_modes(alpha_mode, kernel, stride):
    kh, kw = kernel
    spec_j, spec_t, packed, alpha = _case(24, 8, kh, kw, 3, alpha_mode=alpha_mode)
    x = np.random.default_rng(2).standard_normal((1, 12, 11, 8)).astype(np.float32)
    got, want, structured = _infer_both(spec_j, spec_t, packed, alpha, x,
                                        stride, "VALID")
    _close(got, want)
    _close(got, structured)


@pytest.mark.parametrize("padding,stride,hw", [
    ([(2, 1), (0, 2)], (1, 1), (7, 7)),
    ("SAME_LOWER", (2, 2), (6, 6)),
    ("SAME", (2, 2), (28, 28)),            # even size, stride 2: pads (0, 1)
    ("SAME", (1, 1), (14, 14))])
def test_tiled_conv_infer_padding_rules(padding, stride, hw):
    spec_j, spec_t, packed, alpha = _case(16, 8, 3, 3, 2)
    x = np.random.default_rng(3).standard_normal((1, *hw, 8)).astype(np.float32)
    got, want, structured = _infer_both(spec_j, spec_t, packed, alpha, x,
                                        stride, padding)
    _close(got, want)
    _close(got, structured)


def test_tiled_conv_infer_channel_padding_and_strided_1x1():
    """C = 48 pads to two words; a 1x1 stride-2 downsample (p = 8)."""
    for (c_out, c_in, k, p, stride) in ((64, 48, 3, 4, (1, 1)),
                                        (512, 64, 1, 8, (2, 2))):
        spec_j, spec_t, packed, alpha = _case(c_out, c_in, k, k, p)
        x = np.random.default_rng(c_in).standard_normal((2, 8, 8, c_in)
                                                        ).astype(np.float32)
        got, want, structured = _infer_both(spec_j, spec_t, packed, alpha, x,
                                            stride, "SAME")
        _close(got, want)
        _close(got, structured)


def test_unsupported_padding_string_raises():
    _, spec_t, packed, alpha = _case(16, 8, 3, 3, 2)
    x = torch.zeros((1, 6, 6, 8))
    with pytest.raises(ValueError, match="unsupported padding"):
        tiled_conv_infer(x, torch.from_numpy(packed), torch.from_numpy(alpha),
                         spec_t, padding="WRAP")


def test_tiled_conv_dense_weight_matches_reference():
    for mode in ("tile", "layer"):
        spec_j, spec_t, packed, alpha = _case(12, 40, 3, 2, 3, alpha_mode=mode)
        got = ref.tiled_conv_dense_weight(torch.from_numpy(packed),
                                          torch.from_numpy(alpha), spec_t)
        want = j_tiled_conv_dense_weight(jnp.asarray(packed), jnp.asarray(alpha),
                                         spec_j)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_plain_version_is_the_kernel_arithmetic():
    """B6's plain version equals the dense conv of the unpacked bank on
    pre-padded input, in bf16 and f32, and the CPU wrapper runs it
    without counting a launch."""
    rng = np.random.default_rng(4)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(rng.standard_normal((2, 9, 8, 64)).astype(np.float32)
                             ).to(dtype)
        packed = torch.from_numpy(rng.integers(-2**31, 2**31, (6, 5, 2)
                                               ).astype(np.int32))
        kw_ = dict(kernel=(3, 2), stride=(2, 3), out_hw=(4, 3))
        before = tiled_conv_unique.launches
        got = tiled_conv_unique(x, packed, **kw_)
        assert tiled_conv_unique.launches == before
        assert got.shape == (2, 4, 3, 5) and got.dtype == torch.float32
        bank = unpack_conv_tile(packed, 5, 64, 3, 2)
        want = torch.nn.functional.conv2d(x.float().permute(0, 3, 1, 2), bank,
                                          stride=(2, 3)).permute(0, 2, 3, 1)
        _close(got, want[:, :4, :3])
        _close(tiled_conv_plain(x, packed, **kw_), got, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["dtype", "words", "positions", "small", "ndim"])
def test_wrapper_rejects_bad_operands(bad):
    x = torch.zeros((1, 6, 6, 64))
    packed = torch.zeros((9, 4, 2), dtype=torch.int32)
    kw_ = dict(kernel=(3, 3), stride=(1, 1), out_hw=(4, 4))
    if bad == "dtype":
        x = x.to(torch.float16)
    elif bad == "words":
        packed = torch.zeros((9, 4, 1), dtype=torch.int32)
    elif bad == "positions":
        packed = torch.zeros((4, 4, 2), dtype=torch.int32)
    elif bad == "small":
        kw_["out_hw"] = (5, 4)
    else:
        x = x[0]
    with pytest.raises((TypeError, ValueError)):
        tiled_conv_unique(x, packed, **kw_)


# --------------------------------------------------------------------------
# Conv2D / Dense in every form, and their export
# --------------------------------------------------------------------------
def _policies(form):
    """(JAX policy, port policy) that put a layer in SERVE ``form``."""
    if form == "w":
        return j_fp32_policy(), fp32_policy()
    if form == "wbits":
        return j_bwnn_policy(), bwnn_policy()
    kw_ = dict(min_size=0, alpha_source="A", alpha_mode="tile")
    if form == "tile_flat":
        kw_.update(require_aligned=False)
        return j_tbn_policy(p=3, **kw_), tbn_policy(p=3, **kw_)
    return j_tbn_policy(p=4, **kw_), tbn_policy(p=4, **kw_)


def _layer_pair(cls_j, cls_t, form, **kw):
    pol_j, pol_t = _policies(form)
    layers = {}
    for mode_j, mode_t in ((J_TRAIN, TRAIN), (J_SERVE, SERVE)):
        lj = cls_j(ctx=JModelContext(policy=pol_j, mode=mode_j,
                                     compute_dtype=jnp.float32,
                                     use_pallas=False), **kw)
        lt = cls_t(ctx=ModelContext(policy=pol_t, mode=mode_t,
                                    compute_dtype=torch.float32, device="cpu"),
                   **kw)
        layers[mode_t] = (lj, lt)
    return layers, pol_j, pol_t


def _masters(specs_t, seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
            for k, v in specs_t.items()}


def _check_export(sp_t, sp_j):
    assert set(sp_t) == set(sp_j)
    for k, want in sp_j.items():
        got, want = sp_t[k].numpy(), np.asarray(want)
        assert got.shape == want.shape and got.dtype == want.dtype, k
        if want.dtype == np.int32:
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=ALPHA_RTOL, atol=0,
                                       err_msg=k)


CONV_FORMS = {"tile_conv": {"tile_conv", "alpha"}, "tile_flat": {"tile", "alpha"},
              "wbits": {"wbits", "alpha"}, "w": {"w"}}


@pytest.mark.parametrize("form", list(CONV_FORMS))
@pytest.mark.parametrize("c_in,c_out,kernel,stride", [
    (8, 16, (3, 3), (2, 2)), (48, 24, (3, 3), (1, 1)), (24, 32, (1, 1), (2, 2))])
def test_conv2d_every_form_matches_reference(form, c_in, c_out, kernel, stride):
    if form == "tile_flat" and c_out % 3 == 0:
        c_out += 1          # p = 3 must not divide c_out
    layers, pol_j, pol_t = _layer_pair(JConv2D, Conv2D, form, c_in=c_in,
                                       c_out=c_out, kernel=kernel, stride=stride,
                                       use_bias=True)
    (tj, tt), (sj, st) = layers[TRAIN], layers[SERVE]
    assert set(st.specs()) - {"b"} == CONV_FORMS[form]
    masters = _masters(tt.specs(), c_in + c_out)
    tp_t = {k: torch.from_numpy(v) for k, v in masters.items()}
    tp_j = {k: jnp.asarray(v) for k, v in masters.items()}
    x = np.random.default_rng(7).standard_normal((2, 8, 7, c_in)).astype(np.float32)
    # TRAIN forward and the master gradient (STE) against JAX
    w = tp_t["w"].clone().requires_grad_(True)
    y_t = tt(dict(tp_t, w=w), torch.from_numpy(x))
    y_j = tj(tp_j, jnp.asarray(x))
    _close(y_t, y_j)
    g = np.random.default_rng(8).standard_normal(y_t.shape).astype(np.float32)
    (gw,) = torch.autograd.grad(y_t, w, torch.from_numpy(g))
    gw_j = jax.grad(lambda w_: jnp.sum(tj(dict(tp_j, w=w_), jnp.asarray(x))
                                       * jnp.asarray(g)))(tp_j["w"])
    _close(gw, gw_j, atol=ATOL * float(np.abs(np.asarray(gw_j)).max()))
    # export: words equal, alpha within rtol 1e-6; SERVE forward
    sp_j = j_export(tj.specs(), sj.specs(), tp_j, pol_j)
    sp_t = export_serving_params(tt.specs(), st.specs(), tp_t, pol_t)
    _check_export(sp_t, sp_j)
    y_sj = sj(sp_j, jnp.asarray(x))
    _close(st(sp_t, torch.from_numpy(x)), y_sj)
    _close(y_sj, y_j)    # the shipped form reproduces the TRAIN forward
    assert tile_serving_bytes(sp_t) == j_tile_serving_bytes(sp_j)


DENSE_FORMS = {"tile": {"tile", "alpha"}, "tile_flat": {"tile", "alpha"},
               "wbits": {"wbits", "alpha"}, "w": {"w"}}


@pytest.mark.parametrize("form", list(DENSE_FORMS))
@pytest.mark.parametrize("n_in,n_out,m", [(48, 64, 5), (64, 100, 40)])
def test_dense_every_form_matches_reference(form, n_in, n_out, m):
    if form == "tile_flat":
        n_out += 1
    layers, pol_j, pol_t = _layer_pair(JDense, Dense, form, n_in=n_in,
                                       n_out=n_out, use_bias=True)
    (tj, tt), (sj, st) = layers[TRAIN], layers[SERVE]
    assert set(st.specs()) - {"b"} == DENSE_FORMS[form]
    masters = _masters(tt.specs(), n_in + n_out)
    tp_t = {k: torch.from_numpy(v) for k, v in masters.items()}
    tp_j = {k: jnp.asarray(v) for k, v in masters.items()}
    x = np.random.default_rng(9).standard_normal((m, n_in)).astype(np.float32)
    _close(tt(tp_t, torch.from_numpy(x)), tj(tp_j, jnp.asarray(x)))
    sp_j = j_export(tj.specs(), sj.specs(), tp_j, pol_j)
    sp_t = export_serving_params(tt.specs(), st.specs(), tp_t, pol_t)
    _check_export(sp_t, sp_j)
    _close(st(sp_t, torch.from_numpy(x)), sj(sp_j, jnp.asarray(x)))


def test_bwnn_words_are_row_packed_signs():
    """The BWNN export is sign(W) packed per output filter over (c_in, kh,
    kw) in OIHW order, with alpha = mean|W|."""
    layers, _, pol_t = _layer_pair(JConv2D, Conv2D, "wbits", c_in=5, c_out=3,
                                   kernel=(3, 3))
    tt, st = layers[TRAIN][1], layers[SERVE][1]
    w = torch.from_numpy(_masters(tt.specs(), 1)["w"])
    sp = export_serving_params(tt.specs(), st.specs(), {"w": w}, pol_t)
    assert sp["wbits"].shape == (3, 2) and sp["alpha"].shape == (1,)
    signs = torch.where(w > 0, 1.0, -1.0).reshape(3, 45)
    np.testing.assert_array_equal(sp["wbits"].numpy(), pack_bits(signs).numpy())
    np.testing.assert_allclose(sp["alpha"].numpy(), [float(w.abs().mean())],
                               rtol=ALPHA_RTOL)


def test_conv_export_tile_is_the_flat_tile_in_conv_layout():
    spec = plan_tiling((8, 6, 3, 3), p=2, min_size=0, alpha_source="W")
    w = torch.from_numpy(np.random.default_rng(5).standard_normal(spec.shape
                                                                  ).astype(np.float32))
    pol = tbn_policy(p=2, min_size=0, alpha_source="W")
    tr = Conv2D(6, 8, (3, 3), ModelContext(policy=pol, mode=TRAIN, device="cpu"))
    sv = Conv2D(6, 8, (3, 3), ModelContext(policy=pol, mode=SERVE, device="cpu"))
    sp = export_serving_params(tr.specs(), sv.specs(), {"w": w}, pol)
    t = tile_vector(w, spec)
    np.testing.assert_array_equal(sp["tile_conv"].numpy(),
                                  pack_conv_tile(t, 4, 6, 3, 3).numpy())
