"""Helpers that drive the HTTP shell (``serve/server.py``) deterministically,
shared by the tests and ``chip_smoke.py``.

``hold_after`` gates an ``EngineServer``'s tick thread after a request's
n-th token, so a shutdown always lands while that request is live, whatever
the speed of the host. ``sse_until`` opens a stream and reads it up to its
n-th token event; ``read_to_eof`` reads the rest of it."""
from __future__ import annotations

import asyncio
import json
import threading
import time
from typing import List, Tuple

from repro_torch.serve.client import _read_head, _request_bytes


def hold_after(srv, n_tokens: int, timeout: float = 60.0) -> threading.Event:
    """Hold ``srv``'s tick thread once a request's ``n_tokens``-th token is
    on the detokenize backlog, until ``close()`` asks the tick loop to stop.
    Returns the event set at the hold. Install it before the first request
    is submitted."""
    eng, hook, held = srv.engine, srv.engine.on_token, threading.Event()

    def on_token(req, tok):
        hook(req, tok)
        if len(req.output) == n_tokens:
            held.set()
            t0 = time.monotonic()
            while not srv._stop:
                if time.monotonic() - t0 > timeout:
                    raise RuntimeError(
                        f"close() did not come within {timeout:.0f} s")
                time.sleep(0.001)

    eng.on_token = on_token
    return held


def parse_sse(buf: bytes, events: List[dict]) -> bytes:
    """Append the complete ``data:`` frames of ``buf`` to ``events``;
    returns the unparsed rest."""
    while b"\n\n" in buf:
        frame, buf = buf.split(b"\n\n", 1)
        if frame.startswith(b"data: "):
            events.append(json.loads(frame[6:].decode()))
    return buf


async def sse_until(host: str, port: int, payload: dict, n_tokens: int,
                    timeout: float = 60.0
                    ) -> Tuple[asyncio.StreamReader, asyncio.StreamWriter,
                               List[dict], bytes]:
    """POST /generate and read its SSE frames until ``n_tokens`` token
    events have come; returns ``(reader, writer, events, unparsed bytes)``
    with the connection still open."""
    reader, writer = await asyncio.open_connection(host, port)
    writer.write(_request_bytes("POST", "/generate", payload))
    await writer.drain()
    status, _ = await _read_head(reader)
    if status != 200:
        writer.close()
        raise RuntimeError(f"POST /generate answered {status}")
    events: List[dict] = []
    buf = b""
    while sum("token" in e for e in events) < n_tokens:
        chunk = await asyncio.wait_for(reader.read(4096), timeout)
        if not chunk:
            writer.close()
            raise RuntimeError(
                f"the stream ended after {len(events)} events")
        buf = parse_sse(buf + chunk, events)
    return reader, writer, events, buf


async def read_to_eof(reader: asyncio.StreamReader, buf: bytes,
                      events: List[dict], timeout: float = 60.0) -> List[dict]:
    """Read a stream opened by ``sse_until`` to the server's EOF, appending
    its remaining events; returns ``events``."""
    while chunk := await asyncio.wait_for(reader.read(4096), timeout):
        buf = parse_sse(buf + chunk, events)
    return events
