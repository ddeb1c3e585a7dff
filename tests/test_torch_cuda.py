"""Kernels B1/B2 on the card against their plain PyTorch versions.

Imports neither jax nor the JAX package, so it runs on the GPU machine:

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports jax). Every test is marked
``cuda`` and skips, from a fixture, on a host without a CUDA device.
"""
import pytest
import torch

from repro_torch.core.tiling import plan_tiling
from repro_torch.kernels import ops
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
        pytest.skip("needs a CUDA GPU (kernels B1/B2 have no CPU mode)")
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
