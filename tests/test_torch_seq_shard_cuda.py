"""Sequence-sharded attention on the card: two gloo ranks share ``cuda:0``
(``tests/torch_mesh_worker.py``, mesh (1, 2)) and serve starcoder2-7b
``.reduced()`` in f32 under its "seq" recipe (every head on every rank,
each rank holding the cache rows of the positions = its index mod 2). A
prefill and 4 greedy decode steps under the mesh give the single card's
logits within 1e-4 x max|logit|; each rank's dense cache holds half of the
single card's 16 time rows.

Imports neither jax nor the JAX package, so it runs on the GPU machine:

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_seq_shard_cuda.py

Every test is marked ``cuda`` and skips, from a fixture, on a host without
a CUDA device.
"""
import functools

import pytest
import torch

from repro_torch.configs import build_model, get_config
from repro_torch.launch.serve import build_serving
from repro_torch.nn import module as mod
from repro_torch.nn.context import SERVE, ModelContext
from repro_torch.serve.weights import params_from_numpy
from torch_mesh_worker import cache_shapes, finish_job, start_job

ARCH = "starcoder2-7b"
PROMPT = [5, 3, 2, 7, 1, 4, 6, 2, 9, 9, 1]
DECODE_STEPS = 4
MAX_LEN = 16


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (kernels B1-B6 have no CPU mode)")
    return torch.device("cuda", 0)


@functools.lru_cache(maxsize=None)
def _export():
    """starcoder2-7b .reduced() exported in f32 on the CPU, as numpy."""
    _, sp, _ = build_serving(get_config(ARCH).reduced(), device="cpu", seed=0,
                             compute_dtype=torch.float32)
    return mod.map_tree(lambda v: v.numpy(), sp)


def _single_card(dev):
    """The single card's logits of the same calls, and its caches' shapes."""
    cfg = get_config(ARCH).reduced()
    model = build_model(cfg, ModelContext(policy=cfg.tbn, mode=SERVE,
                                          compute_dtype=torch.float32, device=dev))
    sp = params_from_numpy(_export(), dev)
    with torch.no_grad():
        lg, c, lens = model.prefill(sp, {"tokens": torch.tensor([PROMPT], device=dev)},
                                    MAX_LEN)
        logits = [lg.cpu()]
        for _ in range(DECODE_STEPS):
            lg, c, lens = model.decode_step(sp, lg.argmax(-1)[:, None], c, lens)
            logits.append(lg.cpu())
    return logits, cache_shapes(c)


@pytest.fixture(scope="module")
def seq_job(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (kernels B1-B6 have no CPU mode)")
    from repro_torch.kernels import _build

    _build.build()      # once, before the ranks load the libraries
    case = dict(kind="logits", arch=ARCH, dtype="float32", sp=_export(),
                meshes=[(1, 2)], prompt=PROMPT, max_len=MAX_LEN,
                decode_steps=DECODE_STEPS)
    job = dict(device="cuda:0", meshes=[(1, 2)], cases=[case])
    ranks = finish_job(start_job(job, 2, tmp_path_factory.mktemp("seq_cuda")),
                       timeout=300)
    return [r[(0, (1, 2))] for r in ranks]


def _time_rows(shapes):
    return {p: s[-3] for p, s in shapes.items() if p.split("/")[-1] in ("k", "v")}


@pytest.mark.cuda
def test_meshed_decode_on_time_shards_equals_single_card(cuda_device, seq_job):
    logits, shapes = _single_card(cuda_device)
    assert set(_time_rows(shapes).values()) == {MAX_LEN}
    for rank in seq_job:
        for got, want in zip(rank["logits"], logits, strict=True):
            torch.testing.assert_close(got, want, rtol=0,
                                       atol=1e-4 * float(want.abs().max()))
        held = _time_rows(rank["cache_shapes"])
        assert held and set(held.values()) == {MAX_LEN // 2}
