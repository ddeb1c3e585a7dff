"""Minimal asyncio HTTP/SSE client for the serving front end (port of
``repro/serve/client.py``; stdlib only, the same wire format byte for
byte).

The tests, ``chip_smoke.py`` and any load driver talk to ``EngineServer``
through these helpers, so the wire format is exercised by the same few
dozen lines everywhere.

``sse_generate`` returns every SSE event plus a monotonic receive time per
event, which is what a client needs for TTFT (submit -> first token event)
and ITL (gaps between token events) without instrumenting the server.
"""
from __future__ import annotations

import asyncio
import json
import time
from typing import List, Optional, Tuple


def generate_payload(prompt, *, max_tokens: Optional[int] = None,
                     temperature: Optional[float] = None,
                     top_k: Optional[int] = None,
                     seed: Optional[int] = None,
                     priority: Optional[str] = None,
                     stream: Optional[bool] = None) -> dict:
    """One place that spells the POST /generate body. ``None`` fields are
    omitted so the server's ``SamplingParams.from_json`` sees exactly the
    caller's intent (the engine fills defaults); ``priority`` is the
    scheduling class ("interactive" | "batch") the pressure scheduler
    orders admission by."""
    payload: dict = {"prompt": list(prompt)}
    for key, val in (("max_tokens", max_tokens), ("temperature", temperature),
                     ("top_k", top_k), ("seed", seed),
                     ("priority", priority), ("stream", stream)):
        if val is not None:
            payload[key] = val
    return payload


def _request_bytes(method: str, path: str, body: Optional[dict]) -> bytes:
    data = json.dumps(body).encode() if body is not None else b""
    head = (f"{method} {path} HTTP/1.1\r\n"
            f"Host: localhost\r\n"
            f"Content-Length: {len(data)}\r\n"
            f"Connection: close\r\n\r\n")
    return head.encode() + data


async def _read_head(reader: asyncio.StreamReader) -> Tuple[int, dict]:
    line = await reader.readline()
    status = int(line.split()[1])
    headers = {}
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        k, _, v = h.decode("latin1").partition(":")
        headers[k.strip().lower()] = v.strip()
    return status, headers


async def request_json(host: str, port: int, method: str, path: str,
                       body: Optional[dict] = None) -> Tuple[int, dict]:
    """One plain JSON round-trip (``/stats``, ``/healthz``, rejects,
    non-streaming ``/generate``)."""
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write(_request_bytes(method, path, body))
        await writer.drain()
        status, headers = await _read_head(reader)
        n = int(headers.get("content-length", 0) or 0)
        raw = await reader.readexactly(n) if n else await reader.read()
        return status, json.loads(raw.decode() or "{}")
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except ConnectionError:
            pass


async def request_text(host: str, port: int, method: str = "GET",
                       path: str = "/metrics") -> Tuple[int, str]:
    """One plain-text round-trip — the ``/metrics`` scrape (Prometheus
    text exposition, not JSON). Returns ``(status, body_text)``; error
    statuses return their JSON error body as raw text."""
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write(_request_bytes(method, path, None))
        await writer.drain()
        status, headers = await _read_head(reader)
        n = int(headers.get("content-length", 0) or 0)
        raw = await reader.readexactly(n) if n else await reader.read()
        return status, raw.decode()
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except ConnectionError:
            pass


async def sse_generate(
    host: str, port: int, payload: dict, *,
    read_delay: float = 0.0,
) -> Tuple[int, List[dict], List[float]]:
    """POST /generate and consume the SSE stream to the final event.

    Returns ``(status, events, recv_times)`` — ``recv_times[i]`` is the
    ``time.perf_counter()`` at which event i was parsed. On a non-200
    (e.g. the 429 backpressure reject) the JSON error body comes back as
    the single event. ``read_delay`` sleeps between event reads — the
    deliberately slow consumer the backpressure tests need."""
    reader, writer = await asyncio.open_connection(host, port)
    events: List[dict] = []
    times: List[float] = []
    try:
        writer.write(_request_bytes("POST", "/generate", payload))
        await writer.drain()
        status, headers = await _read_head(reader)
        if status != 200 or "text/event-stream" not in headers.get(
                "content-type", ""):
            n = int(headers.get("content-length", 0) or 0)
            raw = await reader.readexactly(n) if n else await reader.read()
            events.append(json.loads(raw.decode() or "{}"))
            times.append(time.perf_counter())
            return status, events, times
        buf = b""
        while True:
            chunk = await reader.read(4096)
            if not chunk:
                return status, events, times
            buf += chunk
            while b"\n\n" in buf:
                frame, buf = buf.split(b"\n\n", 1)
                if not frame.startswith(b"data: "):
                    continue
                evt = json.loads(frame[len(b"data: "):].decode())
                events.append(evt)
                times.append(time.perf_counter())
                if evt.get("done") or "error" in evt:
                    return status, events, times
            if read_delay:
                await asyncio.sleep(read_delay)
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except ConnectionError:
            pass
