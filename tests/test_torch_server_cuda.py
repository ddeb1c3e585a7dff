"""The serving shell on the card, at ``.reduced()`` granite-8b in bf16: a
warm engine behind ``EngineServer`` (``start(aot=True)`` captures the ticks
as CUDA graphs in a worker thread before the socket is bound; the tick
thread replays them) streams the greedy tokens that a warm engine drained
in-process gives, with no eager tick after warmup, and a mid-flight
``close()`` frees every slot and page.

Imports neither jax nor the JAX package, so it runs on the GPU machine:

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_server_cuda.py

Every test is marked ``cuda`` and skips, from a fixture, on a host without
a CUDA device."""
import asyncio
import functools

import numpy as np
import pytest
import torch

HOST = "127.0.0.1"
ENGINE = dict(n_slots=3, max_len=64, chunk_tokens=8, page_tokens=8)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (kernels B1-B4 have no CPU mode)")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _serving():
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_serving

    cfg = get_config("granite-8b").reduced()
    model, sp, _ = build_serving(cfg, device="cuda", seed=0)
    return cfg, model, sp


def _engine(**kw):
    from repro_torch.serve.engine import BatchedEngine, ServeConfig

    _, model, sp = _serving()
    return BatchedEngine(model, sp, ServeConfig(**{**ENGINE, **kw}))


def _prompts(cfg, n=5):
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(0, cfg.vocab, size=int(k))]
            for k in rng.integers(3, 30, size=n)]


@pytest.mark.cuda
def test_warm_server_streams_the_drained_warm_tokens(cuda_device):
    from repro_torch.serve.client import request_json, sse_generate
    from repro_torch.serve.engine import TRACE_COUNTS
    from repro_torch.serve.sampling import SamplingParams
    from repro_torch.serve.server import EngineServer, ServerConfig

    cfg = _serving()[0]
    prompts, n_tok = _prompts(cfg), 6
    ref = _engine()
    ref.warmup()
    reqs = [ref.submit(p, SamplingParams(max_tokens=n_tok)) for p in prompts]
    ref.run_until_drained()
    want = [r.output for r in reqs]

    async def go():
        srv = EngineServer(_engine(), ServerConfig(host=HOST, port=0))
        port = await srv.start(aot=True)
        traces = TRACE_COUNTS.copy()
        try:
            got = await asyncio.gather(*(sse_generate(
                HOST, port, {"prompt": p, "max_tokens": n_tok}) for p in prompts))
            stats = (await request_json(HOST, port, "GET", "/stats"))[1]
        finally:
            await srv.close()
        return got, stats, TRACE_COUNTS == traces

    got, stats, still = asyncio.run(go())
    assert [[e["token"] for e in ev if "token" in e] for _, ev, _ in got] == want
    assert all(st == 200 and ev[-1]["finish_reason"] == "length" for st, ev, _ in got)
    assert stats["aot_warm"] is True and stats["retraces"] == 0 and still


@pytest.mark.cuda
def test_midflight_close_on_the_card(cuda_device):
    from repro_torch.serve.server import EngineServer, ServerConfig
    from repro_torch.serve.testing import hold_after, read_to_eof, sse_until

    eng = _engine(prefix_cache=False)
    srv = EngineServer(eng, ServerConfig(host=HOST, port=0))
    held = hold_after(srv, 3)

    async def go():
        port = await srv.start(aot=True)
        reader, writer, ev, buf = await sse_until(
            HOST, port, {"prompt": [1, 2, 3], "max_tokens": 40}, 3)
        try:
            await srv.close()
            return await read_to_eof(reader, buf, ev)
        finally:
            writer.close()

    ev = asyncio.run(go())
    toks = [e for e in ev if "token" in e]
    assert held.is_set() and ev[-1]["finish_reason"] == "aborted"
    assert len(toks) == 3 and ev[-1]["text"] == "".join(e["text"] for e in toks)
    assert not srv.detok.alive and not srv._tick_thread.is_alive()
    assert srv._tick_error is None
    assert eng.stats()["live_slots"] == 0 and eng.pool.used_pages == 0
    eng.pool.check()
