"""Training under a mesh on the card: the per-shard kernels of the fused
train forward (B5 on a rank's (p, r/TP * n_in) slab of the masters, B2 on
its r/TP rows planned for the whole (m, r)) against their plain versions
and against one card's whole call, and granite-8b ``.reduced()`` trained by
two gloo ranks sharing ``cuda:0`` (``tests/torch_mesh_worker.py``, meshes
(1, 2) and (2, 1)) against the port on one card.

Imports neither jax nor the JAX package, so it runs on the GPU machine:

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_tp_train_cuda.py

Every test is marked ``cuda`` and skips, from a fixture, on a host without
a CUDA device.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import build_model, get_config
from repro_torch.core.packing import LANE_BITS
from repro_torch.kernels.tile_construct import tile_construct_kernel, tile_construct_plain
from repro_torch.kernels.tiled_matmul import tiled_matmul_plain, tiled_matmul_unique
from repro_torch.nn import module as mod
from repro_torch.nn.context import ModelContext
from repro_torch.optim import adamw
from repro_torch.train.step import build_train_step, init_state
from torch_mesh_worker import finish_job, start_job

P = 8
# (name, n_out, n_in) of granite-8b's tiled Dense at full width
SHAPES = (("gate/up", 14336, 4096), ("down", 4096, 14336), ("k/v", 1024, 4096))
M = 2048           # the fused train step's B * S (4 x 512)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (kernels B1-B6 have no CPU mode)")
    return torch.device("cuda", 0)


def _rank_block(w, tp, t):
    """Rank t's (p * r/TP, n_in) block of a (p * r, n_in) master."""
    v = w.unflatten(0, (P, w.shape[0] // P))
    r_loc = v.shape[1] // tp
    return v[:, t * r_loc:(t + 1) * r_loc].reshape(-1, w.shape[1]).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name,n_out,n_in", SHAPES)
def test_b5_on_a_ranks_slab(cuda_device, name, n_out, n_in, tp):
    gen = torch.Generator(device=cuda_device).manual_seed(n_out + tp)
    w = torch.randn((n_out, n_in), generator=gen, device=cuda_device)
    whole, _ = tile_construct_kernel(w.reshape(P, -1))
    words_per_rank = whole.numel() // tp
    for t in range(tp):
        slab = _rank_block(w, tp, t).reshape(P, -1)
        got = tile_construct_kernel(slab)
        want = tile_construct_plain(slab)
        assert torch.equal(got[0], want[0])
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
        assert torch.equal(got[0], whole[t * words_per_rank:(t + 1) * words_per_rank])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name,n_out,n_in", SHAPES)
def test_b2_on_a_ranks_rows_planned_for_the_whole_call(cuda_device, name, n_out,
                                                       n_in, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(n_in)
    r, words = n_out // P, n_in // LANE_BITS
    packed = torch.randint(-2**31, 2**31, (r, words), generator=gen,
                           device=cuda_device, dtype=torch.int64).to(torch.int32)
    x = torch.randn((M, n_in), generator=gen, device=cuda_device).to(dtype)
    whole = tiled_matmul_unique(x, packed)
    for t in range(2):
        rows = packed[t * r // 2:(t + 1) * r // 2].contiguous()
        got = tiled_matmul_unique(x, rows, plan_shape=(M, r))
        torch.testing.assert_close(got, tiled_matmul_plain(x, rows), rtol=1e-4,
                                   atol=1e-4 * float(got.abs().max()))
        assert torch.equal(got, whole[:, t * r // 2:(t + 1) * r // 2])


ARCH, LR = "granite-8b", 1e-3


@functools.lru_cache(maxsize=None)
def _masters():
    cfg = get_config(ARCH).reduced()
    model = build_model(cfg, ModelContext(policy=cfg.tbn, device="cpu",
                                          compute_dtype=torch.float32))
    return mod.map_tree(lambda v: v.numpy(), model.init(0))


def _batches():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 512, (4, 16)).astype(np.int32) for _ in range(2)]


@pytest.mark.cuda
def test_granite_reduced_trains_on_two_ranks_sharing_the_card(cuda_device, tmp_path):
    cfg = get_config(ARCH).reduced()
    model = build_model(cfg, ModelContext(policy=cfg.tbn, device=cuda_device,
                                          compute_dtype=torch.float32,
                                          fused_train=True))
    params = mod.map_tree(lambda v: torch.from_numpy(v).to(cuda_device), _masters())
    opt = adamw(LR)
    step, state, want = build_train_step(model.train_forward, opt), init_state(params, opt), []
    for b in _batches():
        state, m = step(state, {"tokens": torch.from_numpy(b).to(cuda_device)})
        want.append(float(m["loss"]))
    meshes = [(1, 2), (2, 1)]
    case = dict(kind="train", arch=ARCH, fused=True, dtype="float32",
                masters=_masters(), batches=_batches(), lr=LR,
                probe="seg0/mixer/wk/w", meshes=meshes)
    ranks = finish_job(start_job({"device": "cuda:0", "meshes": meshes,
                                  "cases": [case]}, 2, tmp_path / "job"), timeout=300)
    per_step = 2 * 7 * cfg.n_layers + 1
    for dims in meshes:
        # a rank's m = its rows of the 4 x 16 batch: B2 above MATVEC_MAX_M
        # = 32, B1 at it (the (2, 1) ranks' 2 x 16)
        kernel, other = ("B2", "B1") if 64 // dims[0] > 32 else ("B1", "B2")
        for r in ranks:
            got = r[(0, dims)]
            np.testing.assert_allclose(got["losses"], want, rtol=1e-4)
            c = got["launches"]
            assert c["B5"] == c[kernel] == 2 * per_step and c[other] == 0, c
