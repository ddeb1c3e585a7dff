"""Port parity for kernels B1/B2 and ``kernels.ops.tiled_dense_infer``.

On the CPU the wrappers run their plain PyTorch versions; the same numpy
inputs go through the JAX reference both ways (Pallas interpret mode and
the pure-jnp path). The kernels themselves run only on a CUDA card:
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold them against the
plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.packing import pack_bits as j_pack_bits
from repro.core.tiling import plan_tiling as j_plan_tiling
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch.core.tiling import plan_tiling
from repro_torch.kernels import ops, ref
from repro_torch.kernels.tiled_matmul import tiled_matmul_plain, tiled_matmul_unique
from repro_torch.kernels.tiled_matvec import (
    MATVEC_MAX_M,
    tiled_matvec_plain,
    tiled_matvec_unique,
)

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)


def _case(seed, m, n_in, r, p=4, alpha_mode="tile"):
    """Numpy inputs: x (m, n_in), row-packed tile (r, ceil(n_in/32)) and its
    flat form, alpha, and both packages' TileSpecs."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, n_in)).astype(np.float32)
    t = np.where(rng.random((r, n_in)) < 0.5, 1.0, -1.0).astype(np.float32)
    rows = np.array(j_pack_bits(jnp.asarray(t)))
    flat = np.array(j_pack_bits(jnp.asarray(t.reshape(-1))))
    kw = dict(p=p, min_size=1, alpha_mode=alpha_mode, alpha_source="W")
    spec_j = j_plan_tiling((p * r, n_in), **kw)
    spec_t = plan_tiling((p * r, n_in), **kw)
    alpha = rng.uniform(0.1, 1.1, spec_t.n_alpha).astype(np.float32)
    return x, rows, flat, alpha, spec_j, spec_t


def _pad(x, words):
    return np.pad(x, ((0, 0), (0, words * 32 - x.shape[1])))


@pytest.mark.parametrize("n_in", [64, 80])
@pytest.mark.parametrize("m", [1, 4, 32, 33, 128])
def test_plain_versions_match_reference_oracle(m, n_in):
    x, rows, _, _, _, _ = _case(m + n_in, m, n_in, r=24)
    xp = _pad(x, rows.shape[1])
    want = np.asarray(j_ref.tiled_matvec_unique_ref(
        jnp.asarray(xp), jnp.asarray(rows), n_in=n_in))
    plain = tiled_matvec_plain if m <= MATVEC_MAX_M else tiled_matmul_plain
    wrapper = tiled_matvec_unique if m <= MATVEC_MAX_M else tiled_matmul_unique
    for fn in (plain, wrapper):
        got = fn(torch.from_numpy(xp), torch.from_numpy(rows))
        assert got.dtype == torch.float32 and got.shape == (m, 24)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the port's own oracle agrees too
    np.testing.assert_allclose(
        ref.tiled_matvec_unique_ref(torch.from_numpy(xp), torch.from_numpy(rows),
                                    n_in=n_in).numpy(), want, **TOL)


def test_flat_oracle_matches_reference():
    x, _, flat, _, _, _ = _case(7, 5, 64, r=16)
    want = np.asarray(j_ref.tiled_matmul_unique_ref(
        jnp.asarray(x), jnp.asarray(flat), r=16))
    got = ref.tiled_matmul_unique_ref(torch.from_numpy(x), torch.from_numpy(flat),
                                      r=16)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("alpha_mode", ["layer", "tile"])
@pytest.mark.parametrize("n_in", [64, 80])
@pytest.mark.parametrize("m", [1, 4, 32, 33, 128])
def test_tiled_dense_infer_matches_reference(m, n_in, alpha_mode, use_pallas):
    x, rows, _, alpha, spec_j, spec_t = _case(3 * m + n_in, m, n_in, r=40,
                                              alpha_mode=alpha_mode)
    want = np.asarray(j_ops.tiled_dense_infer(
        jnp.asarray(x), jnp.asarray(rows), jnp.asarray(alpha), spec_j,
        use_pallas=use_pallas))
    got = ops.tiled_dense_infer(torch.from_numpy(x), torch.from_numpy(rows),
                                torch.from_numpy(alpha), spec_t)
    assert got.shape == (m, spec_t.shape[0]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("lead", [(2, 3), (2, 20)])
def test_tiled_dense_infer_lead_dims(lead):
    m = int(np.prod(lead))
    x, rows, _, alpha, spec_j, spec_t = _case(m, m, 80, r=16)
    x = x.reshape(*lead, 80)
    want = np.asarray(j_ops.tiled_dense_infer(
        jnp.asarray(x), jnp.asarray(rows), jnp.asarray(alpha), spec_j,
        use_pallas=True))
    got = ops.tiled_dense_infer(torch.from_numpy(x), torch.from_numpy(rows),
                                torch.from_numpy(alpha), spec_t)
    assert got.shape == (*lead, spec_t.shape[0])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_bf16_activations_keep_dtype_and_match_f32_math():
    x, rows, _, alpha, _, spec_t = _case(11, 6, 64, r=16)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = ops.tiled_dense_infer(xb, torch.from_numpy(rows),
                                torch.from_numpy(alpha), spec_t)
    assert got.dtype == torch.bfloat16
    want = ops.tiled_dense_infer(xb.float(), torch.from_numpy(rows),
                                 torch.from_numpy(alpha), spec_t)
    np.testing.assert_allclose(got.float().numpy(), want.to(torch.bfloat16).float(),
                               rtol=0, atol=0)


@pytest.mark.parametrize("n_in", [64, 80])
def test_flat_tile_cpu_branch_matches_reference(n_in):
    x, _, flat, alpha, spec_j, spec_t = _case(n_in, 9, n_in, r=8)
    want = np.asarray(j_ops.tiled_dense_infer(
        jnp.asarray(x), jnp.asarray(flat), jnp.asarray(alpha), spec_j,
        use_pallas=False))
    got = ops.tiled_dense_infer(torch.from_numpy(x), torch.from_numpy(flat),
                                torch.from_numpy(alpha), spec_t)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_flat_tile_layout_error_on_kernel_path():
    """A flat tile with 32 ∤ n_in cannot feed the kernels; the reference
    raises on its Pallas path, the port on any non-CPU tensor (here the
    meta device, which reaches the kernel path without a card)."""
    x, _, flat, alpha, spec_j, spec_t = _case(5, 4, 80, r=8)
    with pytest.raises(j_ops.FlatTileLayoutError):
        j_ops.tiled_dense_infer(jnp.asarray(x), jnp.asarray(flat),
                                jnp.asarray(alpha), spec_j, use_pallas=True)
    with pytest.raises(ops.FlatTileLayoutError):
        ops.tiled_dense_infer(torch.empty((4, 80), device="meta"),
                              torch.empty(flat.shape, dtype=torch.int32,
                                          device="meta"),
                              torch.empty((4,), device="meta"), spec_t)


@pytest.mark.parametrize("fn", [tiled_matvec_unique, tiled_matmul_unique])
def test_wrappers_refuse_devices_without_a_kernel(fn):
    """Only a CPU tensor takes the plain version: any other device must
    launch a kernel or raise (meta stands in for a device with none)."""
    x = torch.empty((4, 64), device="meta")
    packed = torch.empty((8, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fn(x, packed)


@pytest.mark.parametrize("fn", [tiled_matvec_unique, tiled_matmul_unique])
def test_wrappers_check_operands(fn):
    x = torch.zeros((4, 64))
    packed = torch.zeros((8, 2), dtype=torch.int32)
    with pytest.raises(TypeError):
        fn(x.double(), packed)
    with pytest.raises(TypeError):
        fn(x, packed.long())
    with pytest.raises(ValueError):
        fn(torch.zeros((4, 80)), packed)
    with pytest.raises(ValueError):
        fn(torch.zeros((64, 4)).T, packed)
    assert fn(x, packed).shape == (4, 8)


def test_matvec_refuses_large_m():
    with pytest.raises(ValueError, match="MATVEC_MAX_M"):
        tiled_matvec_unique(torch.zeros((MATVEC_MAX_M + 1, 32)),
                            torch.zeros((4, 1), dtype=torch.int32))


def test_unknown_compute_path_rejected():
    x, rows, _, alpha, _, spec_t = _case(1, 2, 64, r=8)
    with pytest.raises(ValueError, match="compute_path"):
        ops.tiled_dense_infer(torch.from_numpy(x), torch.from_numpy(rows),
                              torch.from_numpy(alpha), spec_t, compute_path="fp8")


@pytest.mark.parametrize("m,r,words", [(128, 512, 128), (128, 128, 128),
                                       (128, 1792, 128), (128, 512, 448),
                                       (33, 512, 128), (512, 6144, 128),
                                       (200, 64, 5), (1, 8, 1)])
def test_split_k_covers_every_word_once(m, r, words):
    """B2's K split (chosen on the host): every split non-empty, together
    exactly the row's words, and enough blocks to fill the card when the
    output has few tiles."""
    from repro_torch.kernels.tiled_matmul import MIN_SPLIT_WORDS, split_k

    splits, per = split_k(m, r, words, sms=132)
    assert splits >= 1 and (splits - 1) * per < words <= splits * per
    assert splits == 1 or per >= MIN_SPLIT_WORDS
    tiles = -(-m // 64) * -(-r // 64)
    assert tiles * splits >= min(132, tiles * max(1, words // MIN_SPLIT_WORDS))
