"""The port's serving shell against the JAX package's, at ``.reduced()``
granite-8b in f32 on the same exported params (masters of ``PRNGKey(0)``,
the port's through ``serve/weights.params_from_numpy``; the JAX engine on
its plain reference, ``use_pallas=False``), with the same ``ServeConfig``.
Every comparison is exact.

* Under greedy decoding each package's ``EngineServer`` serves the same 6
  prompts: every SSE response (status line, headers and every ``data:``
  frame) and every non-streaming JSON response is byte-identical.
* ``PieceCodec`` / ``decode_all`` / ``StreamDetok`` deltas and the
  ``DetokenizeWorker`` events over seeded random ids, with and without a
  piece table, are identical.
* ``SamplingParams.from_json(body).to_json()`` is equal for defaults,
  explicit zeros, extra keys, string numbers and a priority.
* The ``# TYPE`` families the port's ``/metrics`` renders after one
  streamed request include every family the reference renders.
* The scalar ``sample_logits``: greedy ids equal the reference's.
* The serve CLI refuses ``--serve`` for the encoder-decoder family with
  the reference's message, before any build.
"""
import asyncio
import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build_model as j_build_model
from repro.configs import get_config as j_get_config
from repro.launch import serve as j_serve_cli
from repro.nn import module as j_mod
from repro.nn.context import SERVE as J_SERVE
from repro.nn.context import TRAIN as J_TRAIN
from repro.nn.context import ModelContext as JModelContext
from repro.serve import client as j_client
from repro.serve import detok as j_detok
from repro.serve.engine import BatchedEngine as JBatchedEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.sampling import SamplingParams as JSamplingParams
from repro.serve.sampling import sample_logits as j_sample_logits
from repro.serve.server import EngineServer as JEngineServer
from repro.serve.server import ServerConfig as JServerConfig
from repro.serve.weights import export_serving_params as j_export
from repro_torch.configs import build_model, get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.nn.context import SERVE, ModelContext
from repro_torch.serve import client, detok
from repro_torch.serve.engine import BatchedEngine, ServeConfig
from repro_torch.serve.sampling import SamplingParams, sample_logits
from repro_torch.serve.server import EngineServer, ServerConfig
from repro_torch.serve.weights import params_from_numpy

torch.set_num_threads(2)
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
    tp = j_mod.init_params(tm.specs(), jax.random.PRNGKey(0))
    return cfg, sm, j_export(tm.specs(), sm.specs(), tp, cfg.tbn)


@functools.lru_cache(maxsize=None)
def _port_model():
    cfg = get_config("granite-8b").reduced()
    sm = build_model(cfg, ModelContext(policy=cfg.tbn, mode=SERVE,
                                       compute_dtype=torch.float32, device="cpu"))
    return sm, params_from_numpy(jax.tree.map(np.asarray, _export()[2]), "cpu")


def make_server(pkg):
    """A new EngineServer of package ``pkg`` ("jax" | "port") over a new
    engine of ENGINE."""
    if pkg == "jax":
        _, jsm, jsp = _export()
        return JEngineServer(JBatchedEngine(jsm, jsp, JServeConfig(**ENGINE)),
                             JServerConfig(host=HOST, port=0))
    sm, sp = _port_model()
    return EngineServer(BatchedEngine(sm, sp, ServeConfig(**ENGINE)),
                        ServerConfig(host=HOST, port=0))


async def raw_response(port, payload) -> bytes:
    """The whole HTTP response to one POST /generate, as the wire carries
    it (the server closes the connection after it)."""
    reader, writer = await asyncio.open_connection(HOST, port)
    try:
        writer.write(client._request_bytes("POST", "/generate", payload))
        await writer.drain()
        return await reader.read()
    finally:
        writer.close()
        await writer.wait_closed()


@functools.lru_cache(maxsize=None)
def served():
    """Per package: the raw SSE and non-streaming responses to the 6
    prompts (the streams sent concurrently), and the /metrics page after
    one more streamed request."""
    out = {}
    for pkg in ("jax", "port"):
        async def go(pkg=pkg):
            srv = make_server(pkg)
            port = await srv.start(aot=False)
            try:
                sse = await asyncio.gather(*(
                    raw_response(port, {"prompt": p, "max_tokens": m})
                    for p, m in zip(PROMPTS, MAX_TOKENS)))
                js = [await raw_response(port, {"prompt": p, "max_tokens": m,
                                                "stream": False})
                      for p, m in zip(PROMPTS, MAX_TOKENS)]
            finally:
                await srv.close()
            srv = make_server(pkg)
            port = await srv.start(aot=False)
            try:
                await client.sse_generate(HOST, port, {"prompt": [1, 2, 3],
                                                       "max_tokens": 3})
                metrics = await client.request_text(HOST, port)
            finally:
                await srv.close()
            return sse, js, metrics
        out[pkg] = asyncio.run(go())
    return out


@pytest.mark.parametrize("i", range(len(PROMPTS)))
def test_sse_frames_byte_identical(i):
    j_sse, p_sse = served()["jax"][0][i], served()["port"][0][i]
    assert p_sse == j_sse
    head, _, frames = p_sse.partition(b"\r\n\r\n")
    assert head.startswith(b"HTTP/1.1 200 OK")
    assert frames.count(b"data: ") == MAX_TOKENS[i] + 1


@pytest.mark.parametrize("i", range(len(PROMPTS)))
def test_nonstreaming_json_byte_identical(i):
    j_js, p_js = served()["jax"][1][i], served()["port"][1][i]
    assert p_js == j_js
    assert b'"finish_reason": "length"' in p_js


def test_metrics_families_include_the_reference_families():
    def families(text):
        return {line.split()[2] for line in text.splitlines()
                if line.startswith("# TYPE ")}
    (j_status, j_text), (p_status, p_text) = (served()[k][2] for k in ("jax", "port"))
    assert j_status == p_status == 200
    missing = families(j_text) - families(p_text)
    assert not missing, f"families the port does not render: {sorted(missing)}"
    assert "serve_http_request_seconds" in families(p_text)


@pytest.mark.parametrize("table", [None, "pieces"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detokenization_identical(seed, table):
    rng = np.random.default_rng(seed)
    pieces = None
    if table:
        words = ["▁the", "cat", "▁sat", "▁", "s", "▁on", "mat", "", "é", "▁ü"]
        pieces = [words[int(k)] for k in rng.integers(0, len(words), size=40)]
    ids = [int(t) for t in rng.integers(-3, 60, size=80)]
    jc, pc = j_detok.PieceCodec(pieces), detok.PieceCodec(pieces)
    assert detok.decode_all(pc, ids) == j_detok.decode_all(jc, ids)
    js, ps = jc.new_stream(), pc.new_stream()
    assert [ps.feed(t) for t in ids] == [js.feed(t) for t in ids]

    def worker_events(mod, codec):
        got, lock = [], threading.Lock()

        def emit(sid, event):
            with lock:
                got.append((sid, event))
        w = mod.DetokenizeWorker(emit, codec=codec)
        for k, t in enumerate(ids):
            w.push(k % 3, t)
        for sid in range(3):
            w.finish(sid, "length")
        w.close()
        return got, w.peak_depth >= 1
    assert worker_events(detok, pc) == worker_events(j_detok, jc)


BODIES = [
    {},
    {"temperature": 0, "top_k": 0, "seed": 0, "eos_id": 0, "max_tokens": 0},
    {"prompt": [1, 2], "stream": False, "temp": 3.0, "topk": 9, "max_tokens": 7},
    {"temperature": "0.5", "top_k": "3", "max_tokens": "12", "seed": "42",
     "eos_id": "2"},
    {"priority": "interactive", "max_tokens": 5, "temperature": None},
    {"priority": "batch", "max_tokens": 64, "eos_id": -1, "top_k": None},
]


@pytest.mark.parametrize("body", BODIES, ids=range(len(BODIES)))
def test_sampling_params_json_round_trip(body):
    j, p = JSamplingParams.from_json(body), SamplingParams.from_json(body)
    assert p.to_json() == j.to_json()
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    assert SamplingParams.from_json(p.to_json()) == p
    assert SamplingParams._JSON_FIELDS == JSamplingParams._JSON_FIELDS


def test_client_request_bytes_identical():
    payload = client.generate_payload([3, 1, 4], max_tokens=5, temperature=0.0,
                                      top_k=2, seed=9, priority="batch",
                                      stream=False)
    assert payload == j_client.generate_payload(
        [3, 1, 4], max_tokens=5, temperature=0.0, top_k=2, seed=9,
        priority="batch", stream=False)
    for args in (("POST", "/generate", payload), ("GET", "/stats", None)):
        assert client._request_bytes(*args) == j_client._request_bytes(*args)


@pytest.mark.parametrize("top_k", [None, 5])
@pytest.mark.parametrize("shape", [(1, 50), (4, 257)])
def test_sample_logits_greedy_matches_reference(shape, top_k):
    logits = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    want = np.asarray(j_sample_logits(jnp.asarray(logits), jax.random.PRNGKey(0),
                                      temperature=0.0, top_k=top_k))
    got = sample_logits(torch.from_numpy(logits), 0, temperature=0.0, top_k=top_k)
    np.testing.assert_array_equal(got.numpy(), want)
    # stochastic: reproducible from the seed, within the top k
    a = sample_logits(torch.from_numpy(logits), 7, temperature=1.0, top_k=top_k)
    assert torch.equal(a, sample_logits(torch.from_numpy(logits), 7,
                                        temperature=1.0, top_k=top_k))
    if top_k:
        top = torch.topk(torch.from_numpy(logits), top_k).indices
        assert all(int(a[i]) in top[i].tolist() for i in range(shape[0]))


def test_encdec_rejects_http_front_end():
    with pytest.raises(SystemExit, match="token prompts only") as ours:
        serve_cli.main(["--arch", "seamless-m4t-large-v2", "--reduced", "--serve"])
    with pytest.raises(SystemExit) as ref:
        j_serve_cli.main(["--arch", "seamless-m4t-large-v2", "--reduced", "--serve"])
    assert str(ours.value) == str(ref.value)
