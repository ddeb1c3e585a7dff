"""The HTTP/SSE shell over a meshed engine on gloo ranks on the CPU, against
the JAX package's shell on one device.

One job of two ``tests/torch_mesh_worker.py`` ranks, mesh (1, 2), serves
granite-8b ``.reduced()`` in f32 (the masters of ``PRNGKey(0)`` exported by
the JAX package): both ranks warm up, the first runs ``EngineServer``
(``start(aot=True)``) and the other ``follow()``. The first rank streams
6 greedy requests at once over SSE and closes the server:

* every SSE response (status line, headers and each ``data:`` frame) is
  byte-identical to the JAX ``EngineServer``'s for the same request, with
  the same ``ServeConfig`` (the comparison ``test_torch_server_parity.py``
  makes on one device);
* ``close()`` stops both ranks: the follower's ``follow()`` returns after
  the same ticks as the first rank ran, and no tick ran eagerly.
"""
import asyncio
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import build_model as j_build_model
from repro.configs import get_config as j_get_config
from repro.nn import module as j_mod
from repro.nn.context import SERVE as J_SERVE
from repro.nn.context import TRAIN as J_TRAIN
from repro.nn.context import ModelContext as JModelContext
from repro.serve.engine import BatchedEngine as JBatchedEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.server import EngineServer as JEngineServer
from repro.serve.server import ServerConfig as JServerConfig
from repro.serve.weights import export_serving_params as j_export
from repro_torch.serve import client
from torch_mesh_worker import finish_job, start_job

HOST = "127.0.0.1"
ENGINE = dict(n_slots=2, max_len=64, chunk_tokens=8, page_tokens=8)
_rng = np.random.default_rng(0)
PROMPTS = [[int(t) for t in _rng.integers(0, 64, size=int(n))]
           for n in _rng.integers(3, 20, size=6)]
MAX_TOKENS = [int(m) for m in _rng.integers(3, 9, size=6)]


@functools.lru_cache(maxsize=None)
def _export():
    cfg = j_get_config("granite-8b").reduced()
    tm = j_build_model(cfg, JModelContext(policy=cfg.tbn, mode=J_TRAIN,
                                          compute_dtype=jnp.float32))
    sm = j_build_model(cfg, JModelContext(policy=cfg.tbn, mode=J_SERVE,
                                          compute_dtype=jnp.float32,
                                          use_pallas=False))
    sp = j_export(tm.specs(), sm.specs(),
                  j_mod.init_params(tm.specs(), jax.random.PRNGKey(0)), cfg.tbn)
    return sm, sp


async def _raw(port, payload) -> bytes:
    reader, writer = await asyncio.open_connection(HOST, port)
    try:
        writer.write(client._request_bytes("POST", "/generate", payload))
        await writer.drain()
        return await reader.read()
    finally:
        writer.close()
        await writer.wait_closed()


@functools.lru_cache(maxsize=None)
def _jax_sse():
    sm, sp = _export()

    async def go():
        srv = JEngineServer(JBatchedEngine(sm, sp, JServeConfig(**ENGINE)),
                            JServerConfig(host=HOST, port=0))
        port = await srv.start(aot=False)
        try:
            return await asyncio.gather(*(
                _raw(port, {"prompt": p, "max_tokens": m})
                for p, m in zip(PROMPTS, MAX_TOKENS)))
        finally:
            await srv.close()
    return asyncio.run(go())


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """[first rank's result, the follower's]."""
    sp = jax.tree.map(np.asarray, _export()[1])
    case = dict(kind="server", meshes=[(1, 2)], arch="granite-8b", dtype="float32",
                sp=sp, engine=ENGINE, prompts=PROMPTS, max_tokens=MAX_TOKENS)
    started = start_job(dict(device="cpu", meshes=[(1, 2)], cases=[case]), 2,
                        tmp_path_factory.mktemp("mesh_server"))
    _jax_sse()                      # while the ranks run
    return [r[(0, (1, 2))] for r in finish_job(started)]


@pytest.mark.parametrize("i", range(len(PROMPTS)))
def test_meshed_sse_bodies_equal_the_jax_server(served, i):
    got, want = served[0]["sse"][i], _jax_sse()[i]
    assert got == want
    head, _, frames = got.partition(b"\r\n\r\n")
    assert head.startswith(b"HTTP/1.1 200 OK")
    assert frames.count(b"data: ") == MAX_TOKENS[i] + 1


def test_close_stops_every_rank(served):
    first, follower = served
    assert first["stopped"] and follower["stopped"]
    assert follower["ticks"] == first["ticks"] > 0
    assert first["retraces"] == 0
