"""Kernels B1-B4 on the card against their plain PyTorch versions.

Imports neither jax nor the JAX package, so it runs on the GPU machine:

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports jax). Every test is marked
``cuda`` and skips, from a fixture, on a host without a CUDA device.
"""
import pytest
import torch

from repro_torch.core.packing import pack_bits
from repro_torch.core.tiling import plan_tiling
from repro_torch.kernels import ops
from repro_torch.kernels import tiled_xnor as x8
from repro_torch.kernels.tiled_matmul import tiled_matmul_plain, tiled_matmul_unique
from repro_torch.kernels.tiled_matvec import (
    MATVEC_MAX_M,
    tiled_matvec_plain,
    tiled_matvec_unique,
)

torch.set_num_threads(2)
RTOL = 1e-4      # x*±1 is exact in f32: only the summation order differs


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (kernels B1-B4 have no CPU mode)")
    return torch.device("cuda")


def _operands(device, m, k, r, dtype, seed):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device=device).to(dtype)
    packed = torch.randint(0, 2**32, (r, k // 32), generator=gen, device=device,
                           dtype=torch.int64).to(torch.int32)
    return x, packed


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,r", [(1, 32, 1), (4, 96, 130), (17, 160, 65),
                                   (32, 4096, 512), (33, 96, 24),
                                   (128, 4096, 200), (200, 160, 64),
                                   (128, 14336, 512)])
def test_kernel_matches_plain(cuda_device, m, k, r, dtype):
    x, packed = _operands(cuda_device, m, k, r, dtype, m * k + r)
    fn, plain = ((tiled_matvec_unique, tiled_matvec_plain) if m <= MATVEC_MAX_M
                 else (tiled_matmul_unique, tiled_matmul_plain))
    before = fn.launches
    got = fn(x, packed)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(x, packed)
    torch.testing.assert_close(got, want, rtol=RTOL,
                               atol=RTOL * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 128])
def test_tiled_dense_infer_on_card_matches_cpu(cuda_device, m):
    """The dispatch, padding (n_in = 80) and alpha broadcast around the
    kernels, card against CPU (plain versions) on the same inputs."""
    spec = plan_tiling((4 * 24, 80), p=4, min_size=1, alpha_source="W")
    x, packed = _operands(cuda_device, m, 96, 24, torch.float32, m)
    x = x[:, :80].contiguous()
    alpha = torch.rand(4, device=cuda_device) + 0.1
    got = ops.tiled_dense_infer(x, packed, alpha, spec)
    want = ops.tiled_dense_infer(x.cpu(), packed.cpu(), alpha.cpu(), spec)
    torch.testing.assert_close(got.cpu(), want, rtol=RTOL,
                               atol=RTOL * float(want.abs().max()))


def _int_operands(device, path, m, n_in, r, seed):
    """Quantized activations and a tile packed with ``pack_bits`` (pad bits
    0 on both operands when 32 does not divide n_in)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.randn((m, n_in), generator=gen, device=device)
    t = torch.randn((r, n_in), generator=gen, device=device)
    rows = pack_bits(t)
    if path == "xnor":
        return x8.quantize_sign(x, n_in)[0], rows
    q = x8.quantize_int8(x, n_in)[0]
    return torch.nn.functional.pad(q, (0, rows.shape[1] * 32 - n_in)), rows


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["xnor", "int8"])
@pytest.mark.parametrize("m,n_in,r", [(1, 32, 1), (4, 80, 24), (3, 96, 130),
                                      (17, 160, 65), (32, 4096, 512),
                                      (4, 14336, 512), (4, 4096, 6144)])
def test_int_kernel_matches_plain_exactly(cuda_device, path, m, n_in, r):
    a, rows = _int_operands(cuda_device, path, m, n_in, r, m * n_in + r)
    if path == "xnor":
        fn = x8.tiled_xnor_matvec_unique
        call = lambda: fn(a, rows, n_in=n_in)
        want = x8.xnor_matvec_words(a, rows, n_in=n_in)
    else:
        fn = x8.tiled_int8_matvec_unique
        call = lambda: fn(a, rows)
        want = x8.int8_matvec_packed(a, rows, n_in=a.shape[1])
    before = fn.launches
    got = call()
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["xnor", "int8"])
@pytest.mark.parametrize("m", [4, 33])
def test_int_paths_on_card_match_cpu(cuda_device, path, m):
    """Quantize, B3/B4 (m = 4) or B2 (m = 33), scale and alpha broadcast,
    card against CPU on the same inputs (n_in = 80: pad bits). The int32
    accumulators are equal; the f32 scale mean|x| may differ in its last
    bits by summation order, hence rtol 1e-5."""
    spec = plan_tiling((4 * 24, 80), p=4, min_size=1, alpha_source="W")
    _, rows = _int_operands(cuda_device, path, 1, 80, 24, m)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(m)
    x = torch.randn((m, 80), generator=gen, device=cuda_device)
    alpha = torch.rand(4, device=cuda_device) + 0.1
    got = ops.tiled_dense_infer(x, rows, alpha, spec, compute_path=path)
    want = ops.tiled_dense_infer(x.cpu(), rows.cpu(), alpha.cpu(), spec,
                                 compute_path=path)
    rtol = 1e-5 if m <= 32 else RTOL
    torch.testing.assert_close(got.cpu(), want, rtol=rtol,
                               atol=rtol * float(want.abs().max()))
