"""Warm ticks under a mesh on the card: two gloo ranks share ``cuda:0``
(``tests/torch_mesh_worker.py``, mesh (1, 2)) and serve granite-8b
``.reduced()`` in f32. On each rank the decode and extend ticks replayed
after ``warmup()`` (graphs split at each collective, the collectives run
between the replays) give the logits of the same ticks run cold, bit for
bit, and equal on both ranks; each tick holds one graph more than it has
collectives (a tiled layer's gather each, and each layer's attention
output gathered by heads). A single-card engine still captures one graph a tick
(S = 0) and replays its cold logits bit for bit.

Imports neither jax nor the JAX package, so it runs on the GPU machine:

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_mesh_warm_cuda.py

Every test is marked ``cuda`` and skips, from a fixture, on a host without
a CUDA device.
"""
import functools

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.serve import build_serving
from repro_torch.nn import module as mod
from torch_mesh_worker import _replay, finish_job, start_job

ENGINE = dict(n_slots=3, max_len=64, chunk_tokens=8)
NAMES = ("decode_tick", "extend_tick")
TILED_CALLS = 7 * 2 + 1     # q, k, v, o, gate, up, down in 2 layers; the head
HEAD_GATHERS = 2            # each layer's attention output, gathered by heads


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (kernels B1-B6 have no CPU mode)")
    return torch.device("cuda", 0)


@functools.lru_cache(maxsize=None)
def _granite():
    """granite-8b .reduced() exported in f32 on the CPU, as numpy."""
    _, sp, _ = build_serving(get_config("granite-8b").reduced(), device="cpu",
                             seed=0, compute_dtype=torch.float32)
    return mod.map_tree(lambda v: v.numpy(), sp)


def _case(meshes):
    return dict(kind="replay", arch="granite-8b", dtype="float32", sp=_granite(),
                meshes=meshes, engine=ENGINE, seed=3)


@pytest.fixture(scope="module")
def replay_job(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (kernels B1-B6 have no CPU mode)")
    from repro_torch.kernels import _build

    _build.build()      # once, before the ranks load the libraries
    job = dict(device="cuda:0", meshes=[(1, 2)], cases=[_case([(1, 2)])])
    ranks = finish_job(start_job(job, 2, tmp_path_factory.mktemp("mesh_warm_cuda")),
                       timeout=300)
    return [r[(0, (1, 2))] for r in ranks]


@pytest.mark.cuda
def test_meshed_replay_equals_the_cold_tick_bit_for_bit(cuda_device, replay_job):
    first = replay_job[0]
    for rank in replay_job:
        for name in NAMES:
            assert torch.equal(rank["warm"][name], rank["cold"][name]), name
            assert torch.equal(rank["warm"][name], first["warm"][name]), name
            assert rank["sequence"][name] == first["sequence"][name]
            assert rank["collectives"][name] == len(rank["sequence"][name]) == (
                TILED_CALLS + HEAD_GATHERS)
            assert rank["graphs"][name] == TILED_CALLS + HEAD_GATHERS + 1


@pytest.mark.cuda
def test_single_card_engine_captures_one_graph_a_tick(cuda_device):
    out = _replay(_case(None), None, cuda_device)
    for name in NAMES:
        assert out["graphs"][name] == 1 and out["collectives"][name] == 0
        assert out["sequence"][name] == []
        assert torch.equal(out["warm"][name], out["cold"][name]), name
