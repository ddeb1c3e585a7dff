"""The port's serving front-end wall (``repro_torch.serve.server``; the
counterpart of tests/test_server.py and of the HTTP tests of
tests/test_telemetry.py), on the CPU engine at ``.reduced()`` size in f32.

What a client reads off the SSE wire equals what ``run_until_drained``
produces for the same requests, greedy and seeded stochastic, across seeds
and whatever order concurrent submissions race into the admission queue
(a request's explicit ``seed`` roots its stream, independent of the rid
the server hands it). Plus the operational wall: the typed 429, an
interactive request overtaking a batch flood by preemption, slow-consumer
isolation, the bounded buffer's drop policy, ``ServerConfig`` validation,
``/metrics`` with the HTTP histogram (and its 404 with telemetry off), the
stats line, the detokenize backlog, and the shutdown contract (DESIGN.md
§6.3): an idle close is idempotent, and a close that lands while a request
is held live (the tick thread is gated after its 3rd token, so it cannot
finish first) delivers a final ``aborted`` event with the full flushed
text, joins both threads and frees every slot and page.
"""
import asyncio
import contextlib
import functools
import json
import random
import signal
import socket
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import build_model, get_config
from repro_torch.nn import module as mod
from repro_torch.nn.context import SERVE, ModelContext
from repro_torch.serve.client import (
    _read_head,
    _request_bytes,
    request_json,
    request_text,
    sse_generate,
)
from repro_torch.serve.detok import DetokenizeWorker, PieceCodec, decode_all
from repro_torch.serve.engine import BatchedEngine, ServeConfig
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.server import (
    SLOW_DROP,
    EngineServer,
    ServerConfig,
    TokenStream,
    run_server,
)
from repro_torch.serve.telemetry import TICK_PHASES
from repro_torch.serve.testing import hold_after, read_to_eof, sse_until

torch.set_num_threads(2)
HOST = "127.0.0.1"


@functools.lru_cache(maxsize=None)
def build_serve(arch="granite-8b"):
    cfg = get_config(arch).reduced()
    sm = build_model(cfg, ModelContext(policy=cfg.tbn, mode=SERVE,
                                       compute_dtype=torch.float32, device="cpu"))
    return cfg, sm, mod.init_params(sm.specs(), 0, "cpu")


def make_engine(**cfg_kw):
    _, sm, sp = build_serve()
    kw = dict(n_slots=2, max_len=64, chunk_tokens=8, page_tokens=8)
    kw.update(cfg_kw)
    return BatchedEngine(sm, sp, ServeConfig(**kw))


@contextlib.asynccontextmanager
async def serving(engine=None, server_cfg=None, **eng_kw):
    eng = engine if engine is not None else make_engine(**eng_kw)
    srv = EngineServer(eng, server_cfg or ServerConfig(host=HOST, port=0))
    port = await srv.start(aot=False)
    try:
        yield srv, port, eng
    finally:
        await srv.close()


async def wait_stat(port, pred, timeout=15.0):
    t0 = time.perf_counter()
    while True:
        _, s = await request_json(HOST, port, "GET", "/stats")
        if pred(s):
            return s
        assert time.perf_counter() - t0 < timeout, f"stats never settled: {s}"
        await asyncio.sleep(0.01)


def reference_outputs(prompts, params):
    """The ground truth without a server: the same engine config, drained."""
    eng = make_engine()
    reqs = [eng.submit(p, sp) for p, sp in zip(prompts, params)]
    eng.run_until_drained()
    return [list(r.output) for r in reqs]


class TestSSEParity:
    @pytest.mark.parametrize("seed", [0, 1])
    @pytest.mark.parametrize("temperature", [0.0, 1.0])
    def test_stream_matches_drained_engine_shuffled(self, seed, temperature):
        """6 requests raced into the server in a seed-shuffled order stream
        exactly the tokens the drained engine emits for them."""
        rng = np.random.default_rng(seed)
        n = 6
        prompts = [[int(t) for t in rng.integers(0, 64,
                                                 size=int(rng.integers(3, 12)))]
                   for _ in range(n)]
        maxtoks = [int(rng.integers(3, 8)) for _ in range(n)]
        seeds = [1000 * seed + i for i in range(n)]
        ref = reference_outputs(prompts, [
            SamplingParams(max_tokens=m, temperature=temperature, seed=s)
            for m, s in zip(maxtoks, seeds)])

        order = list(range(n))
        random.Random(seed).shuffle(order)

        async def go():
            async with serving() as (srv, port, eng):
                async def one(i, k):
                    await asyncio.sleep(0.01 * k)  # stagger: racy admission
                    return i, await sse_generate(HOST, port, {
                        "prompt": prompts[i], "max_tokens": maxtoks[i],
                        "temperature": temperature, "seed": seeds[i]})
                return await asyncio.gather(
                    *(one(i, k) for k, i in enumerate(order)))

        codec = PieceCodec()
        for i, (status, events, _) in asyncio.run(go()):
            assert status == 200
            toks = [e["token"] for e in events if "token" in e]
            done = events[-1]
            assert done.get("done") and done["finish_reason"] == "length"
            assert toks == ref[i], f"req {i} diverged from engine output"
            # the streamed deltas concatenate to the final text, which is
            # the whole-sequence detokenization
            assert "".join(e["text"] for e in events if "token" in e) \
                == done["text"] == decode_all(codec, toks)
            assert done["n_tokens"] == len(toks) == maxtoks[i]
            assert [e["index"] for e in events if "token" in e] \
                == list(range(len(toks)))

    def test_nonstreaming_matches_stream(self):
        prompt, m = [7, 3, 11, 2], 5

        async def go():
            async with serving() as (srv, port, eng):
                st1, ev, _ = await sse_generate(HOST, port, {
                    "prompt": prompt, "max_tokens": m})
                st2, body = await request_json(HOST, port, "POST",
                                               "/generate", {
                    "prompt": prompt, "max_tokens": m, "stream": False})
                return st1, ev, st2, body
        st1, ev, st2, body = asyncio.run(go())
        assert st1 == st2 == 200
        toks = [e["token"] for e in ev if "token" in e]
        assert body["tokens"] == toks and len(toks) == m
        assert body["text"] == ev[-1]["text"]
        assert body["finish_reason"] == ev[-1]["finish_reason"] == "length"
        assert body["n_tokens"] == m

    def test_healthz_stats_and_errors(self):
        async def go():
            async with serving() as (srv, port, eng):
                health = await request_json(HOST, port, "GET", "/healthz")
                missing = await request_json(HOST, port, "GET", "/nope")
                bad = await request_json(HOST, port, "POST", "/generate",
                                         {"max_tokens": 2})
                long = await request_json(HOST, port, "POST", "/generate",
                                          {"prompt": list(range(65)),
                                           "max_tokens": 2})
                await sse_generate(HOST, port,
                                   {"prompt": [1, 2], "max_tokens": 2})
                stats = await request_json(HOST, port, "GET", "/stats")
                return health, missing, bad, long, stats
        health, missing, bad, long, stats = asyncio.run(go())
        assert health == (200, {"ok": True})
        assert missing == (404, {"error": "not_found", "path": "/nope"})
        assert bad[0] == 400 and bad[1]["error"] == "bad_request"
        assert bad[1]["detail"].startswith("KeyError")
        assert long[0] == 400 and long[1]["error"] == "bad_prompt"
        st = stats[1]
        assert st["streams_opened"] >= 1 and st["tokens_out"] >= 2
        assert st["open_streams"] == 0 and st["detok_backlog"] == 0
        for key in ("queue_depth", "peak_queue_depth", "live_slots",
                    "preempt_free_tick_rate", "aot_warm"):
            assert key in st
        assert st["aot_warm"] is False and st["retraces"] == 0

    def test_tick_failure_fails_streams_and_later_requests(self):
        """A tick that raises stops the tick thread: the live stream gets
        its final ``aborted`` event and the next request a 500; nothing
        carries on."""
        async def go():
            eng = make_engine()

            def broken():
                raise RuntimeError("device lost")

            async with serving(engine=eng) as (srv, port, _):
                eng.step = broken
                st, ev, _ = await sse_generate(HOST, port, {
                    "prompt": [1, 2, 3], "max_tokens": 4})
                after = await request_json(HOST, port, "POST", "/generate", {
                    "prompt": [1], "max_tokens": 2, "stream": False})
                return srv, st, ev, after
        srv, st, ev, after = asyncio.run(go())
        assert st == 200 and ev == [{"done": True, "finish_reason": "aborted",
                                     "text": "", "n_tokens": 0}]
        assert after == (500, {"error": "engine_failed", "detail": "device lost"})
        assert not srv._tick_thread.is_alive()


    def test_run_server_stops_and_raises_on_a_tick_failure(self):
        """``run_server`` (the CLI's entry point) does not keep serving
        after a failed tick: it shuts down and raises the tick's error."""
        eng = make_engine()

        def broken():
            raise RuntimeError("device lost")
        eng.step = broken

        async def go():
            clients = []

            def ready(srv, port):
                clients.append(asyncio.ensure_future(sse_generate(
                    HOST, port, {"prompt": [1, 2], "max_tokens": 2})))
            with pytest.raises(RuntimeError, match="engine tick failed") as err:
                await asyncio.wait_for(run_server(
                    eng, ServerConfig(host=HOST, port=0), aot=False,
                    ready=ready), 30)
            return err.value, await clients[0]
        err, (st, ev, _) = asyncio.run(go())
        assert str(err.__cause__) == "device lost"
        assert st == 200 and ev[-1]["finish_reason"] == "aborted"

class TestBackpressure:
    def test_admission_queue_full_is_typed_429(self):
        """Slot busy and queue at capacity: the next submit gets an HTTP 429
        with the typed body at once, and the in-flight requests finish."""
        async def go():
            async with serving(n_slots=1, max_queued=1,
                               max_len=160) as (srv, port, eng):
                t1 = asyncio.ensure_future(sse_generate(HOST, port, {
                    "prompt": [1, 2, 3], "max_tokens": 96}))
                await wait_stat(port, lambda s: s["live_slots"] == 1)
                t2 = asyncio.ensure_future(sse_generate(HOST, port, {
                    "prompt": [4, 5, 6], "max_tokens": 8}))
                await wait_stat(port, lambda s: s["queue_depth"] == 1)
                status, body = await request_json(HOST, port, "POST",
                                                  "/generate", {
                    "prompt": [9], "max_tokens": 2, "stream": False})
                (st1, ev1, _), (st2, ev2, _) = await t1, await t2
                stats = (await request_json(HOST, port, "GET", "/stats"))[1]
                return status, body, st1, ev1, st2, ev2, stats
        status, body, st1, ev1, st2, ev2, stats = asyncio.run(go())
        assert status == 429
        assert body == {"error": "admission_queue_full", "queued": 1,
                        "capacity": 1, "retry": True}
        assert st1 == 200 and ev1[-1].get("done")
        assert st2 == 200 and ev2[-1].get("done")
        assert stats["rejected"] >= 1 and stats["http_rejects"] >= 1

    def test_interactive_overtakes_batch_flood_on_the_wire(self):
        """A 1-slot engine saturated by a long batch stream: an interactive
        request arriving mid-decode preempts it, finishes first, and neither
        stream's tokens differ from the FIFO engine's."""
        b_prompt, b_max = [1, 2, 3], 48
        i_prompt, i_max = [9, 8, 7], 4

        async def go():
            eng = make_engine(n_slots=1, max_len=160, priorities=True,
                              preempt=True)
            async with serving(engine=eng) as (srv, port, _):
                tb = asyncio.ensure_future(sse_generate(HOST, port, {
                    "prompt": b_prompt, "max_tokens": b_max,
                    "priority": "batch"}))
                await wait_stat(port, lambda s: s["live_slots"] == 1
                                and s["tokens_out"] >= 2)
                ti = asyncio.ensure_future(sse_generate(HOST, port, {
                    "prompt": i_prompt, "max_tokens": i_max,
                    "priority": "interactive"}))
                (stb, evb, tmb), (sti, evi, tmi) = await tb, await ti
                bad = await request_json(HOST, port, "POST", "/generate", {
                    "prompt": [1], "max_tokens": 2, "stream": False,
                    "priority": "urgent"})
                stats = (await request_json(HOST, port, "GET", "/stats"))[1]
                return stb, evb, tmb, sti, evi, tmi, bad, stats

        stb, evb, tmb, sti, evi, tmi, bad, stats = asyncio.run(go())
        assert stb == sti == 200
        assert evb[-1].get("done") and evi[-1].get("done")
        # the interactive stream closed while the batch one still decoded
        assert tmi[-1] < tmb[-1], (tmi[-1], tmb[-1])
        assert stats["preempts"] >= 1 and stats["resumes"] >= 1
        assert stats["parked"] == 0 and stats["live_slots"] == 0
        assert set(stats["class_counts"]) == {"batch", "interactive"}
        ref_b, ref_i = reference_outputs(
            [b_prompt, i_prompt],
            [SamplingParams(max_tokens=b_max), SamplingParams(max_tokens=i_max)])
        assert [e["token"] for e in evb if "token" in e] == ref_b
        assert [e["token"] for e in evi if "token" in e] == ref_i
        assert bad[0] == 400 and bad[1]["error"] == "bad_prompt"

    def test_slow_consumer_cannot_stall_other_streams(self):
        """A client that stops reading its SSE socket is detected (drain
        timeout against small socket buffers) and disconnected; concurrent
        fast streams finish with their full output meanwhile."""
        cfg = ServerConfig(host=HOST, port=0, stream_buffer=4,
                           write_high_water=64, sndbuf=4096,
                           drain_timeout=0.3)

        async def go():
            async with serving(server_cfg=cfg, n_slots=2,
                               max_len=512) as (srv, port, eng):
                s = socket.socket()
                s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
                s.connect((HOST, port))
                # limit= caps the client transport's read-ahead, so the TCP
                # window closes within a few KB of events
                reader, writer = await asyncio.open_connection(
                    sock=s, limit=1024)
                writer.write(_request_bytes("POST", "/generate", {
                    "prompt": [1, 2, 3], "max_tokens": 480}))
                await writer.drain()
                await _read_head(reader)   # headers only, then never read
                fast = []
                for _ in range(3):
                    fast.append(await sse_generate(HOST, port, {
                        "prompt": [4, 5, 6], "max_tokens": 6}))
                await wait_stat(port, lambda s_: s_["slow_disconnects"] >= 1)
                stats = await wait_stat(
                    port, lambda s_: s_["live_slots"] == 0
                    and s_["open_streams"] == 0)
                writer.close()
                return fast, stats, srv.counters
        fast, stats, counters = asyncio.run(go())
        for st, ev, _ in fast:
            assert st == 200 and ev[-1].get("done")
            assert len([e for e in ev if "token" in e]) == 6
        assert counters["slow_disconnects"] >= 1
        assert stats["aborted"] >= 1 and stats["client_aborts"] >= 1
        assert stats["pages_in_use"] == 0

    def test_token_stream_drop_policy_buffer(self):
        """Overflow drops token events and sticks the flag; the final event
        always lands."""
        async def go():
            ts = TokenStream(maxsize=2)
            for i in range(5):
                ts.push({"token": i, "text": f"t{i}", "index": i})
            ts.push({"done": True, "finish_reason": "length",
                     "text": "", "n_tokens": 5})
            got = []
            while True:
                e = await ts.next()
                got.append(e)
                if e.get("done"):
                    return ts, got
        ts, got = asyncio.run(go())
        assert ts.overflowed and ts.dropped == 3
        assert [e.get("token") for e in got] == [0, 1, None]
        assert got[-1]["done"] and ts.finished

    def test_drop_policy_on_the_wire_keeps_final_event(self):
        """Policy "drop": events that reach a full stream buffer are shed
        (each later event says how many), and the final event, with the
        whole text, always lands. The loop thread is held until the request
        has finished, so its events reach the 1-event buffer back to back."""
        cfg = ServerConfig(host=HOST, port=0, stream_buffer=1,
                           slow_policy=SLOW_DROP)

        async def go():
            async with serving(server_cfg=cfg) as (srv, port, eng):
                task = asyncio.ensure_future(sse_generate(
                    HOST, port, {"prompt": [1, 2, 3], "max_tokens": 24}))
                await wait_stat(port, lambda s: s["open_streams"] == 1)
                t0 = time.monotonic()
                while eng.has_work or srv.detok.depth:
                    assert time.monotonic() - t0 < 30, "request never finished"
                    time.sleep(0.005)
                time.sleep(0.05)             # the last emit is queued
                st, ev, _ = await task
                return st, ev, srv.counters
        st, ev, counters = asyncio.run(go())
        toks = [e for e in ev if "token" in e]
        done = ev[-1]
        assert st == 200 and done["done"] and done["n_tokens"] == 24
        assert counters["sse_dropped_events"] >= 1
        assert len(toks) + counters["sse_dropped_events"] == 24
        assert toks[-1]["dropped"] == counters["sse_dropped_events"]
        ref = reference_outputs([[1, 2, 3]], [SamplingParams(max_tokens=24)])[0]
        assert done["text"] == decode_all(PieceCodec(), ref)
        assert [e["token"] for e in toks] == [ref[e["index"]] for e in toks]

    def test_server_config_validation(self):
        with pytest.raises(ValueError, match="slow_policy"):
            ServerConfig(slow_policy="explode")
        with pytest.raises(ValueError, match="stream_buffer"):
            ServerConfig(stream_buffer=0)
        ServerConfig(slow_policy=SLOW_DROP)  # valid


class TestShutdown:
    def test_midflight_close_flushes_and_frees(self):
        """close() while a request is held live after its 3rd token: a final
        ``aborted`` event whose text is the full flush of every token
        emitted before shutdown, both threads joined, zero live slots and
        zero pool pages in use."""
        async def go():
            eng = make_engine(n_slots=2, max_len=256, prefix_cache=False)
            srv = EngineServer(eng, ServerConfig(host=HOST, port=0))
            held = hold_after(srv, 3)
            port = await srv.start(aot=False)
            try:
                reader, writer, events, buf = await sse_until(
                    HOST, port, {"prompt": [1, 2, 3], "max_tokens": 200}, 3)
                assert held.is_set()
            finally:
                await srv.close()
            # the handler task flushes the backlog's final event to the
            # still-open connection, then EOF
            await read_to_eof(reader, buf, events)
            writer.close()
            return srv, eng, events

        srv, eng, events = asyncio.run(go())
        done = events[-1]
        toks = [e for e in events if "token" in e]
        assert done.get("done") and done["finish_reason"] == "aborted"
        assert len(toks) == 3
        assert done["text"] == "".join(e["text"] for e in toks)
        assert done["n_tokens"] == len(toks)
        assert not srv.detok.alive
        assert not srv._tick_thread.is_alive()
        assert srv._tick_error is None       # aborted by close(), not a fault
        st = eng.stats()
        assert st["live_slots"] == 0 and st["queue_depth"] == 0
        assert st["aborted"] == 1
        assert eng.pool.used_pages == 0
        eng.pool.check()

    def test_run_server_sigint_aborts_a_live_stream_and_cuts_a_silent_client(self):
        """SIGINT to ``run_server`` while one stream is held live after its
        3rd token and another connection never sends its request: the stop
        follows ``close()``'s order (since Python 3.12.1 waiting on the
        server's open connections first would let the stream run on to
        ``length`` and the silent client hold the process forever). The
        stream ends ``aborted`` with its flushed text, the silent connection
        is cut after ``drain_timeout``, and run_server returns."""
        assert threading.current_thread() is threading.main_thread()
        eng = make_engine(n_slots=2, max_len=256, prefix_cache=False)

        async def go():
            booted = asyncio.get_running_loop().create_future()

            def ready(srv, port):
                booted.set_result((srv, port, hold_after(srv, 3, timeout=20)))
            runner = asyncio.ensure_future(run_server(
                eng, ServerConfig(host=HOST, port=0, drain_timeout=0.5),
                aot=False, ready=ready))
            srv, port, held = await asyncio.wait_for(booted, 30)
            s_reader, s_writer = await asyncio.open_connection(HOST, port)
            reader, writer, events, buf = await sse_until(
                HOST, port, {"prompt": [1, 2, 3], "max_tokens": 200}, 3)
            assert held.is_set()
            t0 = time.perf_counter()
            signal.raise_signal(signal.SIGINT)
            await asyncio.wait({runner}, timeout=10)
            dt = time.perf_counter() - t0
            if not runner.done():            # a stuck stop: unwind, then fail
                s_writer.close()
                writer.close()
                srv._stop = True
                await asyncio.wait({runner}, timeout=30)
                pytest.fail(f"run_server still serving {dt:.1f} s after SIGINT")
            runner.result()
            await read_to_eof(reader, buf, events, timeout=5)
            silent_eof = await asyncio.wait_for(s_reader.read(), 5)
            writer.close()
            s_writer.close()
            return srv, events, silent_eof, dt

        srv, events, silent_eof, dt = asyncio.run(go())
        toks = [e for e in events if "token" in e]
        assert events[-1]["finish_reason"] == "aborted" and len(toks) == 3
        assert events[-1]["text"] == "".join(e["text"] for e in toks)
        assert silent_eof == b"" and dt < 5
        assert not srv.detok.alive and not srv._tick_thread.is_alive()
        assert srv._tick_error is None and not srv._writers
        assert eng.stats()["live_slots"] == 0 and eng.pool.used_pages == 0
        eng.pool.check()

    def test_close_cuts_a_connection_that_never_sends(self):
        """A client that connects and sends nothing cannot hold close()
        beyond ``drain_timeout``."""
        async def go():
            cfg = ServerConfig(host=HOST, port=0, drain_timeout=0.2)
            async with serving(server_cfg=cfg) as (srv, port, eng):
                reader, writer = await asyncio.open_connection(HOST, port)
                await wait_stat(port, lambda s: True)
            t0 = time.perf_counter()
            await srv.close()                # already closed: returns at once
            eof = await asyncio.wait_for(reader.read(), 5)
            writer.close()
            return srv, eof, time.perf_counter() - t0
        srv, eof, dt = asyncio.run(go())
        assert eof == b"" and dt < 5
        assert not srv._writers and not srv.detok.alive

    def test_close_idempotent_and_empty(self):
        async def go():
            async with serving() as (srv, port, eng):
                await request_json(HOST, port, "GET", "/healthz")
            await srv.close()                # second close: no-op
            return srv
        srv = asyncio.run(go())
        assert not srv.detok.alive and not srv._tick_thread.is_alive()


class TestMetricsEndpoint:
    def test_metrics_endpoint_and_http_histogram(self):
        async def go():
            async with serving() as (srv, port, eng):
                await sse_generate(HOST, port, {
                    "prompt": [1, 2, 3], "max_tokens": 3})
                status, text = await request_text(HOST, port, "GET", "/metrics")
                _, stats = await request_json(HOST, port, "GET", "/stats")
            return status, text, stats

        status, text, stats = asyncio.run(go())
        assert status == 200
        for name in ("serve_requests_submitted_total 1",
                     "serve_tokens_total 3",
                     "# TYPE serve_tick_seconds histogram",
                     "# TYPE serve_http_request_seconds histogram",
                     'serve_http_request_seconds_count{route="/generate"} 1',
                     "serve_streams_opened_total 1",
                     "# TYPE serve_open_streams gauge",
                     "# TYPE serve_detok_backlog_peak gauge"):
            assert name in text, f"missing from /metrics: {name!r}"
        for phase in TICK_PHASES:
            assert f'serve_tick_phase_seconds_count{{phase="{phase}"}}' in text
        assert stats["latency"]["ttft_ms"]["count"] == 1
        assert stats["latency"]["http_ms"]["/generate"]["count"] == 1

    def test_metrics_404_when_disabled(self):
        async def go():
            async with serving(telemetry=False) as (srv, port, eng):
                return await request_text(HOST, port, "GET", "/metrics")

        status, body = asyncio.run(go())
        assert status == 404
        assert json.loads(body)["error"] == "telemetry_disabled"

    @pytest.mark.parametrize("telemetry", [True, False])
    def test_stats_line(self, telemetry):
        """The periodic report reads the registry (or the engine's counters
        with telemetry off); its rate covers the tokens since the last
        call."""
        async def go():
            async with serving(telemetry=telemetry) as (srv, port, eng):
                srv.stats_line()
                await sse_generate(HOST, port, {"prompt": [1, 2], "max_tokens": 5})
                return srv.stats_line(), srv.stats_line()
        first, second = asyncio.run(go())
        assert "tokens=5 " in first and "live=0/2" in first
        assert "tok/s=    0.0 tokens=5" in second
        assert ("ttft_p50=" in first) == telemetry


class TestDetokenizeWorker:
    def test_events_peak_and_close_flushes(self):
        """Events per stream in push order; the peak depth is the largest
        backlog seen at a push; close() delivers everything queued before
        it, then joins."""
        got, gate = [], threading.Event()

        def emit(sid, event):
            gate.wait(10)
            got.append((sid, event))

        w = DetokenizeWorker(emit, codec=PieceCodec(["a", "▁b", "c"]))
        for tok in (0, 1, 2, 7):
            w.push("s", tok)
        w.push("t", 1)
        w.finish("s", "aborted")
        assert w.peak_depth >= 4
        gate.set()
        w.close()
        assert not w.alive and w.depth == 0
        s_events = [e for sid, e in got if sid == "s"]
        assert [e.get("text") for e in s_events] == ["a", " b", "c", " t7",
                                                     "a bc t7"]
        assert s_events[-1] == {"done": True, "finish_reason": "aborted",
                                "text": "a bc t7", "n_tokens": 4}
        assert [e for sid, e in got if sid == "t"] == [
            {"token": 1, "text": "b", "index": 0}]
        w.close()                            # idempotent
