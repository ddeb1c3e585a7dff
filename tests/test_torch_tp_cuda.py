"""Tensor-parallel serving on the card: two gloo ranks share ``cuda:0``
(``tests/torch_mesh_worker.py``, mesh (1, 2)). Each rank runs kernels
B1-B4 and B6 on its r/TP rows (filters), held against the plain versions
on one device (the CPU); granite-8b ``.reduced()`` in f32 gives the
single-card logits through prefill and decode, and the single-card
engine's tokens with the same kernel launches per rank.

Imports neither jax nor the JAX package, so it runs on the GPU machine:

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_tp_cuda.py

Every test is marked ``cuda`` and skips, from a fixture, on a host without
a CUDA device.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import build_model, get_config
from repro_torch.core.packing import pack_bits, pack_conv_tile
from repro_torch.core.tiling import plan_tiling
from repro_torch.kernels import ops
from repro_torch.launch.serve import build_serving
from repro_torch.nn import module as mod
from repro_torch.nn.context import SERVE, ModelContext
from repro_torch.serve.engine import BatchedEngine, ServeConfig
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.weights import params_from_numpy
from torch_mesh_worker import _counters, finish_job, start_job

RTOL = 1e-4       # x*±1 is exact in f32: only the summation order differs
INT_RTOL = 1e-5   # exact int32 accumulators; the f32 scale's sum reorders
PATHS = ("float", "xnor", "int8")
MS = (1, 4, 33)
K, R, P = 4096, 512, 8      # granite-8b's q/o projection: (4096, 256) a rank
PROMPT = [5, 3, 2, 7, 1, 4, 6, 2]
ENGINE = dict(n_slots=3, max_len=64, chunk_tokens=8)
PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9]]
GREEDY = [dict(max_tokens=4)] * 3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (kernels B1-B6 have no CPU mode)")
    return torch.device("cuda", 0)


def _dense_inputs():
    gen = torch.Generator().manual_seed(3)
    t = torch.where(torch.rand((R, K), generator=gen) < 0.5, 1.0, -1.0)
    spec = plan_tiling((P * R, K), p=P, min_size=1, alpha_source="W")
    return dict(rows=pack_bits(t).numpy(),
                alpha=(0.1 + torch.rand(spec.n_alpha, generator=gen)).numpy(),
                xs={m: torch.randn((m, K), generator=gen).numpy() for m in MS},
                spec=spec)


def _conv_inputs():
    gen = torch.Generator().manual_seed(5)
    shape = (2 * 128, 64, 3, 3)          # p = 2: 128 unique filters
    spec = plan_tiling(shape, p=2, min_size=1, alpha_source="W")
    t = torch.where(torch.rand(spec.q, generator=gen) < 0.5, 1.0, -1.0)
    return dict(packed=pack_conv_tile(t, 128, 64, 3, 3).numpy(),
                alpha=(0.1 + torch.rand(spec.n_alpha, generator=gen)).numpy(),
                x=torch.randn((2, 14, 14, 64), generator=gen).numpy(),
                stride=(1, 1), padding="SAME", spec=spec)


@functools.lru_cache(maxsize=None)
def _granite():
    """granite-8b .reduced() exported in f32 on the CPU, as numpy."""
    _, sp, _ = build_serving(get_config("granite-8b").reduced(), device="cpu",
                             seed=0, compute_dtype=torch.float32)
    return mod.map_tree(lambda v: v.numpy(), sp)


def _single_card(dev):
    """The single-card logits, engine tokens and launches on the ranks'
    export."""
    cfg = get_config("granite-8b").reduced()
    s_model = build_model(cfg, ModelContext(policy=cfg.tbn, mode=SERVE,
                                            compute_dtype=torch.float32, device=dev))
    sp = params_from_numpy(_granite(), dev)
    with torch.no_grad():
        lg, c, lens = s_model.prefill(sp, {"tokens": torch.tensor([PROMPT], device=dev)},
                                      16)
        logits = [lg.cpu()]
        for _ in range(4):
            lg, c, lens = s_model.decode_step(sp, lg.argmax(-1)[:, None], c, lens)
            logits.append(lg.cpu())
    eng = BatchedEngine(s_model, sp, ServeConfig(**ENGINE))
    reqs = [eng.submit(np.asarray(p, np.int32), SamplingParams(**kw))
            for p, kw in zip(PROMPTS, GREEDY)]
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    eng.run_until_drained()
    return logits, [r.output for r in reqs], {k: fn.launches
                                              for k, fn in counters.items()}


@pytest.fixture(scope="module")
def tp_job(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (kernels B1-B6 have no CPU mode)")
    from repro_torch.kernels import _build

    _build.build()      # once, before the ranks load the libraries
    d, c = _dense_inputs(), _conv_inputs()
    model = dict(arch="granite-8b", dtype="float32", sp=_granite(), meshes=[(1, 2)])
    cases = [
        dict(kind="dense", meshes=[(1, 2)], paths=PATHS, xs=d["xs"], rows=d["rows"],
             alpha=d["alpha"], spec=dataclasses.asdict(d["spec"])),
        dict(kind="conv", meshes=[(1, 2)], packed=c["packed"], alpha=c["alpha"],
             x=c["x"], stride=c["stride"], padding=c["padding"],
             spec=dataclasses.asdict(c["spec"])),
        dict(model, kind="logits", prompt=PROMPT, max_len=16, decode_steps=4),
        dict(model, kind="engine", engine=ENGINE, prompts=PROMPTS, sampling=GREEDY),
    ]
    job = dict(device="cuda:0", meshes=[(1, 2)], cases=cases)
    ranks = finish_job(start_job(job, 2, tmp_path_factory.mktemp("tp_cuda")),
                       timeout=300)
    return [[r[(i, (1, 2))] for r in ranks] for i in range(len(cases))]


@pytest.mark.cuda
@pytest.mark.parametrize("path", PATHS)
def test_per_shard_decode_and_extend_kernels(cuda_device, tp_job, path):
    d = _dense_inputs()
    own = {"float": "B1", "xnor": "B3", "int8": "B4"}[path]
    for rank in tp_job[0]:
        assert rank["rows_held"] == R // 2
        assert rank["launches"][own] >= 2 and rank["launches"]["B2"] >= 3
        for m in MS:
            plain = ops.tiled_dense_infer(torch.from_numpy(d["xs"][m]),
                                          torch.from_numpy(d["rows"]),
                                          torch.from_numpy(d["alpha"]), d["spec"],
                                          compute_path=path)
            got = rank[f"{path}/{m}"]
            tol = INT_RTOL if path != "float" and m <= 32 else RTOL
            torch.testing.assert_close(got, plain, rtol=tol,
                                       atol=tol * float(plain.abs().max()))


@pytest.mark.cuda
def test_per_shard_conv_kernel(cuda_device, tp_job):
    c = _conv_inputs()
    plain = ops.tiled_conv_infer(torch.from_numpy(c["x"]), torch.from_numpy(c["packed"]),
                                 torch.from_numpy(c["alpha"]), c["spec"],
                                 stride=c["stride"], padding=c["padding"])
    for rank in tp_job[1]:
        assert rank["filters_held"] == 64
        torch.testing.assert_close(rank["y"], plain, rtol=RTOL,
                                   atol=RTOL * float(plain.abs().max()))


@pytest.mark.cuda
def test_granite_logits_tokens_and_launches_equal_single_card(cuda_device, tp_job):
    logits, tokens, launches = _single_card(cuda_device)
    for rank in tp_job[2]:
        for got, want in zip(rank["logits"], logits, strict=True):
            torch.testing.assert_close(got, want, rtol=0,
                                       atol=1e-4 * float(want.abs().max()))
    for rank in tp_job[3]:
        assert rank["tokens"] == tokens
        assert rank["launches"] == launches and launches["B1"] > 0
