"""Async HTTP/SSE serving front end over ``BatchedEngine`` (port of
``repro/serve/server.py``).

Dataflow (DESIGN.md §6.3), three threads with one-way handoffs:

    asyncio loop (1 thread)          engine thread           detok thread
    ------------------------         --------------          ------------
    POST /generate ──submit──▶ admission queue
                               tick loop: step() ──on_token──▶ backlog
    TokenStream.push ◀──call_soon_threadsafe── codec ◀────────── drain
    SSE writer ◀── bounded per-stream buffer

* The HTTP layer is plain asyncio streams with four routes: ``POST
  /generate`` (JSON body -> SSE stream of token events, or one JSON reply
  with ``stream: false``), ``GET /stats`` (engine and server counters, with
  histogram quantiles when telemetry is on), ``GET /metrics`` (the engine's
  telemetry registry in Prometheus text format, with the HTTP families this
  module registers into it) and ``GET /healthz``. The body's optional
  ``"priority"`` ("interactive" | "batch") rides through
  ``SamplingParams.from_json`` into the admission queue; an unknown class
  is a 400.
* The ENGINE THREAD owns every ``step()``: every tick, eager or a CUDA
  graph replay, and every device call the engine makes. It drains the
  abort queue and ticks while work exists, sleeping on a condition
  variable otherwise. It selects the engine's CUDA device itself (the
  current device is per thread). ``submit`` only enqueues on the engine's
  thread-safe queue: a handler never ticks and never waits on the device.
* Detokenization runs on the backlog thread (serve/detok.py): the tick's
  ``on_token`` hook is one queue put. Text re-enters the loop thread via
  ``call_soon_threadsafe`` into per-stream BOUNDED buffers.
* Backpressure is typed end to end: a full admission queue
  (``ServeConfig.max_queued``) raises ``AdmissionQueueFull`` -> HTTP 429
  with a JSON body. A slow SSE consumer hits its stream's bounded buffer:
  policy ``"disconnect"`` ends that stream (and aborts its request),
  ``"drop"`` sheds token events but keeps the final event; no other stream
  stalls, since each connection is its own task and the engine never waits
  on a writer.
* ``close()`` is the mid-flight shutdown contract: stop accepting, join
  the tick thread, abort every queued, live and parked request (slots and
  pool pages free), flush the detokenize backlog (every token emitted
  before shutdown still reaches its stream as text), then join the backlog
  thread.
* ``start(aot=True)`` runs ``BatchedEngine.warmup()`` in a worker thread
  before the socket is bound and before the tick thread starts: on a card
  the ticks are captured as CUDA graphs in global capture mode, so no other
  thread may touch the device meanwhile, and the first request's TTFT holds
  no capture.
* A tick that raises stops the tick thread: every stream gets its final
  ``aborted`` event, later requests get a 500, and ``run_server`` stops and
  re-raises the error after its shutdown. Nothing falls back or carries on.
* ``stats()`` and ``/metrics`` read host state only, so a scrape never
  synchronizes the device from the loop thread.
* Over a meshed engine (``BatchedEngine(mesh=)``) the shell runs on the
  mesh's first rank only, and every other rank runs ``engine.follow()``:
  each ``step()`` of the tick thread first sends the calls since the last
  tick (the handlers' submits, the aborts) to the followers, which then
  run the same tick (``serve/control.py``). An idle tick thread still
  steps every ``control.HEARTBEAT_S`` seconds, so a follower never waits
  on the group's timeout. ``close()`` ends with ``stop_followers()``
  unless a tick failed (a failed rank takes the others' next collective
  down with it); a meshed engine then steps no more, so it serves one
  server. ``start(aot=True)`` warms the engine up, which under a mesh is
  collective: every rank warms up first (``warmup()`` is then a no-op
  here), as the CLI does.
"""
from __future__ import annotations

import asyncio
import collections
import dataclasses
import json
import queue
import socket
import threading
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.serve.control import HEARTBEAT_S
from repro_torch.serve.detok import DetokenizeWorker, PieceCodec
from repro_torch.serve.engine import AdmissionQueueFull, BatchedEngine, Request
from repro_torch.serve.sampling import SamplingParams

# the /metrics histogram's route label vocabulary — anything else maps to
# "other" so a path-scanning client cannot mint unbounded label children
_ROUTES = ("/generate", "/stats", "/metrics", "/healthz")

SLOW_DISCONNECT = "disconnect"
SLOW_DROP = "drop"


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    host: str = "127.0.0.1"
    port: int = 8000                 # 0 -> OS-assigned (tests)
    stream_buffer: int = 256         # per-stream bounded event buffer
    slow_policy: str = SLOW_DISCONNECT   # bounded-buffer overflow policy
    drain_timeout: float = 5.0       # max seconds a writer may sit in
    # drain() before the consumer is declared slow (policy applies)
    write_high_water: Optional[int] = None  # transport write buffer limit
    # in bytes; tiny values make drain() engage at test scale
    sndbuf: Optional[int] = None     # SO_SNDBUF on accepted connections;
    # like write_high_water this exists so the slow-consumer policy is
    # testable: default kernel buffers absorb ~100s of KB before drain()
    # ever blocks, far past what a short test stream emits

    def __post_init__(self):
        if self.slow_policy not in (SLOW_DISCONNECT, SLOW_DROP):
            raise ValueError(
                f"slow_policy must be '{SLOW_DISCONNECT}' or '{SLOW_DROP}':"
                f" {self.slow_policy!r}")
        if self.stream_buffer < 1:
            raise ValueError(
                f"stream_buffer must be >= 1: {self.stream_buffer}")


class TokenStream:
    """One request's bounded event buffer, owned by the loop thread.

    ``push`` (called via ``call_soon_threadsafe``) appends token events
    up to ``maxsize``; past that the event is DROPPED and the overflow
    flag sticks — the consumer's policy decides whether that means
    disconnect or just gaps. The final (``done``) event always lands:
    it is the one event a consumer cannot re-derive."""

    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self._buf: collections.deque = collections.deque()
        self._wake = asyncio.Event()
        self.overflowed = False
        self.dropped = 0
        self.finished = False

    def push(self, event: dict) -> bool:
        if event.get("done"):
            self.finished = True
            self._buf.append(event)
            self._wake.set()
            return True
        if len(self._buf) >= self.maxsize:
            self.overflowed = True
            self.dropped += 1
            self._wake.set()
            return False
        self._buf.append(event)
        self._wake.set()
        return True

    async def next(self) -> dict:
        while not self._buf:
            self._wake.clear()
            await self._wake.wait()
        return self._buf.popleft()


class EngineServer:
    """The asyncio front end; one per ``BatchedEngine``."""

    def __init__(self, engine: BatchedEngine, cfg: ServerConfig = None,
                 *, codec: Optional[PieceCodec] = None):
        if not engine.is_first:
            raise ValueError("the HTTP shell over a meshed engine runs on the "
                             "mesh's first rank; this rank runs "
                             "engine.follow()")
        self.engine = engine
        self._meshed = engine.mesh is not None
        self.cfg = cfg or ServerConfig()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._streams: Dict[int, TokenStream] = {}
        self._writers: set = set()      # open connections (loop thread)
        self._closed = False
        self.counters = {"streams_opened": 0, "slow_disconnects": 0,
                         "http_rejects": 0, "client_aborts": 0,
                         "sse_dropped_events": 0}
        # HTTP-side metric families, registered into the ENGINE's
        # registry so one /metrics scrape covers the whole process; the
        # fn-backed counters read the dict above, which only the loop
        # thread writes
        self._http_hist = None
        tel = engine.tel
        if tel is not None:
            r = tel.registry
            self._http_hist = r.histogram(
                "serve_http_request_seconds",
                "HTTP request handling, accept to close, by route",
                labels=("route",))
            for key, name, help_ in (
                ("streams_opened", "serve_streams_opened_total",
                 "Token streams opened by POST /generate"),
                ("slow_disconnects", "serve_slow_disconnects_total",
                 "Streams ended by the slow-consumer policy"),
                ("http_rejects", "serve_http_rejects_total",
                 "HTTP 429 responses from admission backpressure"),
                ("client_aborts", "serve_client_aborts_total",
                 "Requests aborted because the client disconnected"),
                ("sse_dropped_events", "serve_sse_dropped_events_total",
                 "Token events shed by bounded stream buffers"),
            ):
                r.counter(name, help_,
                          fn=lambda k=key: self.counters[k])
            r.gauge("serve_open_streams", "Live token streams",
                    fn=lambda: len(self._streams))
            r.gauge("serve_detok_backlog",
                    "Tokens queued for detokenization",
                    fn=lambda: self.detok.depth)
            r.gauge("serve_detok_backlog_peak",
                    "High-water mark of the detokenize backlog",
                    fn=lambda: self.detok.peak_depth)
        # throughput state for the periodic stats line (tokens at the
        # previous stats_line() call -> tok/s over the interval)
        self._last_stats = (time.monotonic(), 0)

        # engine thread machinery; a CUDA engine's device index is fixed
        # here, since a new thread's current device is device 0
        self._cuda_index = (
            (engine.device.index if engine.device.index is not None
             else torch.cuda.current_device())
            if engine.device.type == "cuda" else None)
        self._failed: Optional[asyncio.Event] = None
        self._stop = False
        self._wake = threading.Condition()
        self._abort_q: "queue.Queue[Request]" = queue.Queue()
        self._tick_error: Optional[BaseException] = None
        self._tick_thread = threading.Thread(
            target=self._tick_loop, name="engine-tick", daemon=True)

        # engine -> detok handoff (engine thread side is two queue puts)
        engine.on_token = lambda req, tok: self.detok.push(req.rid, tok)
        engine.on_finish = lambda req: self.detok.finish(
            req.rid, req.finish_reason or "aborted")
        self.detok = DetokenizeWorker(self._emit, codec=codec)

    # ---- lifecycle ----------------------------------------------------
    async def start(self, *, aot: bool = True) -> int:
        """Bind, optionally AOT-warm the engine, start the tick thread.
        Returns the bound port (useful with ``port=0``)."""
        self._loop = asyncio.get_running_loop()
        self._failed = asyncio.Event()
        if aot:
            # warm BEFORE binding and before the tick thread starts: a
            # capture in the first request would sit in its TTFT, and a
            # CUDA graph capture (global mode) needs the device to itself.
            # to_thread keeps the loop responsive meanwhile.
            await asyncio.to_thread(self._warmup)
        self._server = await asyncio.start_server(
            self._handle, self.cfg.host, self.cfg.port)
        self._tick_thread.start()
        return self.port

    def _on_device(self) -> None:
        """Make the engine's card this thread's current device."""
        if self._cuda_index is not None:
            torch.cuda.set_device(self._cuda_index)

    def _warmup(self):
        self._on_device()
        return self.engine.warmup()

    @property
    def port(self) -> int:
        return self._server.sockets[0].getsockname()[1]

    async def serve_forever(self):
        async with self._server:
            await self._server.serve_forever()

    async def close(self):
        """Mid-flight-safe shutdown; see the module docstring contract.

        The acceptor stops first, but the open connections are waited for
        only after the detokenize backlog is flushed: since Python 3.12.1
        ``Server.wait_closed()`` waits for every open connection, so
        waiting before the tick thread stops would let a live stream run to
        its natural end (``length``) instead of being aborted."""
        if self._closed:
            return
        self._closed = True
        if self._server is not None:
            self._server.close()
        self._stop = True
        with self._wake:
            self._wake.notify_all()
        if self._tick_thread.is_alive() or self._tick_thread.ident:
            await asyncio.to_thread(self._tick_thread.join, 30.0)
            if self._tick_thread.is_alive():
                # abort_all would race a running step(): refuse instead
                raise RuntimeError("engine tick thread did not stop within "
                                   "30 s of close()")
        # tick thread is down -> abort is now safe; every live/queued
        # request fires on_finish -> a final "aborted" event per stream
        self.engine.abort_all()
        if self._tick_error is None:
            self.engine.stop_followers()
        # sentinel lands BEHIND the aborts' final events: joining here
        # guarantees partial text of mid-flight streams was flushed
        await asyncio.to_thread(self.detok.close)
        if self._server is not None:
            await self._close_connections()

    async def _close_connections(self):
        """Let each open connection write what its stream holds (the final
        event at least) and close; cut the ones still open after
        ``drain_timeout`` (a client that never sent its request)."""
        try:
            await asyncio.wait_for(self._server.wait_closed(),
                                   self.cfg.drain_timeout)
        except asyncio.TimeoutError:
            for writer in list(self._writers):
                writer.transport.abort()
            await self._server.wait_closed()

    # ---- engine thread ------------------------------------------------
    def _tick_loop(self):
        eng = self.engine
        self._on_device()
        beat = time.monotonic()
        while not self._stop:
            while not self._abort_q.empty():
                try:
                    eng.abort(self._abort_q.get_nowait())
                except queue.Empty:      # pragma: no cover
                    break
            # has_work counts parked (preempted) requests too: a parked
            # stream with an empty queue still needs ticks to resume; a
            # meshed engine's idle step is its followers' heartbeat
            if not eng.has_work and not (
                    self._meshed and time.monotonic() - beat >= HEARTBEAT_S):
                with self._wake:
                    if self._stop:
                        return
                    self._wake.wait(0.05)
                continue
            try:
                eng.step()
                beat = time.monotonic()
            except BaseException as e:   # fail every stream, then stop
                self._tick_error = e
                self._stop = True
                eng.abort_all()
                self._signal_failure()
                if not isinstance(e, Exception):
                    raise
                return

    def _signal_failure(self):
        if self._loop is not None and not self._loop.is_closed():
            try:
                self._loop.call_soon_threadsafe(self._failed.set)
            except RuntimeError:         # loop closed mid-call
                pass

    def _kick(self):
        with self._wake:
            self._wake.notify_all()

    # ---- detok thread -> loop thread ----------------------------------
    def _emit(self, sid, event: dict):
        if self._loop is None or self._loop.is_closed():
            return
        try:
            self._loop.call_soon_threadsafe(self._deliver, sid, event)
        except RuntimeError:             # loop closed mid-call
            pass

    def _deliver(self, sid, event: dict):
        stream = self._streams.get(sid)
        if stream is not None and not stream.push(event):
            # bounded-buffer shed (push keeps the final event always)
            self.counters["sse_dropped_events"] += 1

    # ---- HTTP ---------------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter):
        t0 = time.perf_counter()
        route = "other"
        self._writers.add(writer)
        try:
            if self.cfg.write_high_water is not None:
                writer.transport.set_write_buffer_limits(
                    high=self.cfg.write_high_water)
            if self.cfg.sndbuf is not None:
                sock = writer.get_extra_info("socket")
                if sock is not None:
                    sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF,
                                    self.cfg.sndbuf)
            line = await reader.readline()
            if not line:
                return
            try:
                method, path, _ = line.decode("latin1").split()
            except ValueError:
                await self._respond(writer, 400, {"error": "bad_request"})
                return
            headers = {}
            while True:
                h = await reader.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
                k, _, v = h.decode("latin1").partition(":")
                headers[k.strip().lower()] = v.strip()
            body = b""
            n = int(headers.get("content-length", 0) or 0)
            if n:
                body = await reader.readexactly(n)

            route = path if path in _ROUTES else "other"
            if method == "GET" and path == "/healthz":
                await self._respond(writer, 200, {"ok": True})
            elif method == "GET" and path == "/stats":
                await self._respond(writer, 200, self.stats())
            elif method == "GET" and path == "/metrics":
                await self._metrics(writer)
            elif method == "POST" and path == "/generate":
                await self._generate(writer, body)
            else:
                await self._respond(writer, 404, {"error": "not_found",
                                                  "path": path})
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            self._writers.discard(writer)
            if self._http_hist is not None:
                # for SSE this spans the whole stream, not just the
                # headers — /generate's histogram child reads as
                # "connection lifetime", the GET routes as true latency
                self._http_hist.labels(route=route).observe(
                    time.perf_counter() - t0)
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, RuntimeError):
                pass

    async def _metrics(self, writer):
        """Prometheus text exposition of the shared registry. A typed
        404 with telemetry off: scraping a deliberately dark engine is a
        config error worth a loud answer, not an empty page."""
        tel = self.engine.tel
        if tel is None:
            await self._respond(writer, 404, {
                "error": "telemetry_disabled",
                "detail": "engine built with ServeConfig(telemetry=False)"})
            return
        data = tel.registry.render().encode()
        with _suppress_conn():
            writer.write(
                f"HTTP/1.1 200 OK\r\n"
                f"Content-Type: text/plain; version=0.0.4; "
                f"charset=utf-8\r\n"
                f"Content-Length: {len(data)}\r\n"
                f"Connection: close\r\n\r\n".encode() + data)
            await writer.drain()

    async def _generate(self, writer, body: bytes):
        try:
            payload = json.loads(body.decode() or "{}")
            prompt = payload["prompt"]
            params = SamplingParams.from_json(payload)
        except (KeyError, ValueError, TypeError) as e:
            await self._respond(writer, 400, {
                "error": "bad_request", "detail": f"{type(e).__name__}: {e}"})
            return
        if self._tick_error is not None:
            await self._respond(writer, 500, {
                "error": "engine_failed", "detail": str(self._tick_error)})
            return
        streaming = bool(payload.get("stream", True))
        try:
            req = self.engine.submit(prompt, params)
        except AdmissionQueueFull as e:
            self.counters["http_rejects"] += 1
            await self._respond(writer, 429, {
                "error": "admission_queue_full",
                "queued": e.queued, "capacity": e.capacity,
                "retry": True})
            return
        except ValueError as e:
            await self._respond(writer, 400, {
                "error": "bad_prompt", "detail": str(e)})
            return
        # Register BEFORE yielding control: _deliver runs on this same
        # loop thread, so no token event can slip between submit and this
        # assignment. Non-streaming requests buffer every event (a request
        # emits at most max_tokens+1), streaming ones get the bounded
        # buffer the slow-consumer policy guards.
        maxsize = (self.cfg.stream_buffer if streaming
                   else req.params.max_tokens + 2)
        stream = TokenStream(maxsize)
        self._streams[req.rid] = stream
        self.counters["streams_opened"] += 1
        self._kick()
        try:
            if streaming:
                await self._stream_sse(writer, req, stream)
            else:
                await self._collect_json(writer, req, stream)
        finally:
            self._streams.pop(req.rid, None)
            if not req.done:
                # client went away mid-generation: hand the abort to the
                # tick thread (engine.abort is not tick-concurrent-safe)
                self.counters["client_aborts"] += 1
                self._abort_q.put(req)
                self._kick()

    async def _stream_sse(self, writer, req: Request, stream: TokenStream):
        writer.write(
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: text/event-stream\r\n"
            b"Cache-Control: no-cache\r\n"
            b"Connection: close\r\n\r\n")
        disconnect = self.cfg.slow_policy == SLOW_DISCONNECT
        while True:
            if stream.overflowed and disconnect:
                self.counters["slow_disconnects"] += 1
                with _suppress_conn():
                    writer.write(_sse({"error": "slow_consumer",
                                       "policy": SLOW_DISCONNECT}))
                return
            event = await stream.next()
            if stream.dropped and not event.get("done"):
                event = dict(event, dropped=stream.dropped)
            try:
                writer.write(_sse(event))
                await asyncio.wait_for(writer.drain(),
                                       self.cfg.drain_timeout)
            except asyncio.TimeoutError:
                # the socket would not take the bytes in time: the
                # consumer is slow at the transport level, same verdict
                # as a buffer overflow
                self.counters["slow_disconnects"] += 1
                return
            except ConnectionError:
                return                   # client is simply gone
            if event.get("done"):
                return

    async def _collect_json(self, writer, req: Request,
                            stream: TokenStream):
        tokens, text = [], []
        while True:
            event = await stream.next()
            if event.get("done"):
                await self._respond(writer, 200, {
                    "tokens": tokens, "text": event["text"],
                    "finish_reason": event["finish_reason"],
                    "n_tokens": event["n_tokens"]})
                return
            tokens.append(event["token"])
            text.append(event["text"])

    async def _respond(self, writer, status: int, body: dict):
        phrase = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  429: "Too Many Requests", 500: "Internal Server Error"}
        data = json.dumps(body, default=_json_default).encode()
        with _suppress_conn():
            writer.write(
                f"HTTP/1.1 {status} {phrase.get(status, 'Error')}\r\n"
                f"Content-Type: application/json\r\n"
                f"Content-Length: {len(data)}\r\n"
                f"Connection: close\r\n\r\n".encode() + data)
            await writer.drain()

    def stats(self) -> dict:
        s = self.engine.stats()
        s.update(self.counters)
        s["detok_backlog"] = self.detok.depth
        s["detok_backlog_peak"] = self.detok.peak_depth
        s["open_streams"] = len(self._streams)
        tel = self.engine.tel
        if tel is not None and self._http_hist is not None:
            # the engine already contributed s["latency"]; fold the HTTP
            # route histograms in beside it (ms, bucket-interpolated)
            s["latency"]["http_ms"] = {
                "/".join(lv for _, lv in child.labels) or "all": {
                    "p50": _ms(child.quantile(0.50)),
                    "p99": _ms(child.quantile(0.99)),
                    "count": child.count,
                }
                for child in self._http_hist.children.values()
            }
        return s

    def stats_line(self) -> str:
        """One-line steady-state report for the CLI's ``--stats-interval``
        loop, sourced from the telemetry registry (value_of reads the
        same children /metrics renders). Throughput is measured over the
        window since the previous call."""
        tel = self.engine.tel
        now = time.monotonic()
        t_prev, tok_prev = self._last_stats
        if tel is not None:
            tokens = tel.registry.value_of("serve_tokens_total") or 0
        else:                            # registry off: engine counters
            tokens = self.engine.stats()["tokens_out"]
        self._last_stats = (now, tokens)
        rate = (tokens - tok_prev) / max(now - t_prev, 1e-9)
        s = self.engine.stats()
        pools = " ".join(
            f"{fam}={f['utilization']:.0%}"
            for fam, f in sorted(s.get("cache_families", {}).items())
        ) or "n/a"
        line = (
            f"tok/s={rate:7.1f} tokens={tokens} "
            f"live={s['live_slots']}/{self.engine.cfg.n_slots} "
            f"parked={s['parked']} queued={s['queue_depth']} "
            f"streams={len(self._streams)} pool[{pools}] "
            f"prefix_hit={s['hit_rate']:.0%} "
            f"detok_backlog={self.detok.depth}"
        )
        if tel is not None:
            lat = s["latency"]
            p50 = lat["ttft_ms"]["p50"]
            itl = lat["itl_ms"]["p50"]
            line += (f" ttft_p50={p50 if p50 is not None else '-'}ms"
                     f" itl_p50={itl if itl is not None else '-'}ms")
            retr = s.get("retraces", 0)
            if retr:
                line += f" RETRACES={retr}"
        return line


def _ms(v: Optional[float]) -> Optional[float]:
    return None if v is None else round(1e3 * v, 3)


def _sse(event: dict) -> bytes:
    return b"data: " + json.dumps(
        event, default=_json_default).encode() + b"\n\n"


def _json_default(o):
    if hasattr(o, "item"):
        return o.item()
    return str(o)


class _suppress_conn:
    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        return et is not None and issubclass(et, ConnectionError)


async def run_server(engine: BatchedEngine, cfg: ServerConfig = None,
                     *, aot: bool = True, codec=None,
                     ready: Optional[Callable] = None,
                     stats_interval: float = 0.0):
    """Boot and serve until signalled (the CLI entry point).

    SIGINT/SIGTERM are turned into a graceful stop via the loop's signal
    handler: a raw KeyboardInterrupt would otherwise be raised into
    whatever handler task happens to be running and leak a traceback
    mid-``writer.write``. ``stats_interval > 0`` prints the one-line
    telemetry report (``EngineServer.stats_line``) every that many
    seconds for the CLI's ``--stats-interval``. A failed tick also stops
    the server; after the shutdown its error is raised, as is any error of
    the serving tasks."""
    import signal

    srv = EngineServer(engine, cfg, codec=codec)
    port = await srv.start(aot=aot)
    if ready is not None:
        ready(srv, port)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    hooked = []
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
            hooked.append(sig)
        except (NotImplementedError, RuntimeError):
            pass  # non-main thread / platform without signal support
    serving = asyncio.ensure_future(srv.serve_forever())
    waiters = [asyncio.ensure_future(stop.wait()),
               asyncio.ensure_future(srv._failed.wait())]
    tasks = [serving, *waiters]
    if stats_interval > 0:
        async def _stats_loop():
            while True:
                await asyncio.sleep(stats_interval)
                print(f"[stats] {srv.stats_line()}", flush=True)

        tasks.append(asyncio.ensure_future(_stats_loop()))
    try:
        await asyncio.wait({serving, *waiters},
                           return_when=asyncio.FIRST_COMPLETED)
    finally:
        for task in tasks[1:]:
            task.cancel()
        try:
            # close() first, in its own order: it stops the acceptor (which
            # ends serve_forever) and the tick thread before anything waits
            # on the open connections. Cancelling serve_forever first would
            # wait on them (Python >= 3.12.1) with the tick thread running:
            # a live stream would run on to its end, and a client that never
            # sends its request would hold the process.
            await srv.close()
        finally:
            for writer in list(srv._writers):  # left only if close() failed
                writer.transport.abort()
            serving.cancel()
            results = await asyncio.gather(*tasks, return_exceptions=True)
            for sig in hooked:
                loop.remove_signal_handler(sig)
    for res in results:
        if isinstance(res, Exception):
            raise res
    if srv._tick_error is not None:
        raise RuntimeError("an engine tick failed; the server stopped"
                           ) from srv._tick_error
