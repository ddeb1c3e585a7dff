"""The port's serve CLI in HTTP mode (``--serve``; the counterpart of
tests/test_server.py's ``TestServeCLI``), on the CPU.

A subprocess boots ``--serve --port 0 --device cpu --reduced``: the
readiness line says ``(aot=on)`` (``--aot`` defaults on under ``--serve``),
one request streams over SSE, ``/stats`` reports the warm engine,
``/metrics`` the tick histogram and the HTTP families, ``--stats-interval``
prints a ``[stats]`` line, SIGINT stops it cleanly even with a connection
open that never sends its request (exit 0, ``server closed``, no
traceback) and ``--trace-log`` is written at shutdown.
In-process: without a card and without ``--device cpu`` the HTTP mode
raises as the batch mode does (no CPU fallback), and a negative
``--stats-interval`` is refused.
"""
import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from repro_torch.device import NoCudaDeviceError
from repro_torch.launch import serve as serve_cli
from repro_torch.serve.client import request_json, request_text, sse_generate

ROOT = Path(__file__).resolve().parents[1]
HOST = "127.0.0.1"


@pytest.mark.subprocess
def test_serve_boot_sse_and_clean_sigint(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    trace_log = tmp_path / "trace.jsonl"
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "granite-8b", "--reduced", "--device", "cpu", "--serve", "--port", "0",
         "--slots", "2", "--max-len", "48", "--chunk-tokens", "16",
         "--page-tokens", "8", "--stats-interval", "0.5",
         "--trace-log", str(trace_log)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=ROOT, env=env,
        text=True)
    try:
        port = None
        t0 = time.time()
        lines = []
        while time.time() - t0 < 120:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("serving on http://"):
                port = int(line.split(":")[2].split()[0])
                break
        assert port, f"no readiness line: {''.join(lines)}"
        assert lines[-1].strip().endswith("(aot=on)"), lines[-1]

        async def go():
            st, ev, _ = await sse_generate(HOST, port, {
                "prompt": [1, 2, 3], "max_tokens": 4})
            stats = await request_json(HOST, port, "GET", "/stats")
            metrics = await request_text(HOST, port, "GET", "/metrics")
            return st, ev, stats, metrics
        st, ev, (_, stats), (mst, mtext) = asyncio.run(go())
        assert st == 200
        assert len([e for e in ev if "token" in e]) == 4
        assert ev[-1].get("done") and ev[-1]["finish_reason"] == "length"
        assert stats["aot_warm"] is True and stats["retraces"] == 0
        assert mst == 200
        for name in ("serve_requests_submitted_total 1",
                     "serve_tokens_total 4",
                     "# TYPE serve_tick_seconds histogram",
                     'serve_http_request_seconds_count{route="/generate"} 1',
                     "serve_streams_opened_total 1"):
            assert name in mtext, f"missing from /metrics: {name!r}"
        tick_count = int([ln for ln in mtext.splitlines()
                          if ln.startswith("serve_tick_seconds_count")][0].split()[-1])
        assert tick_count > 0
        t0 = time.time()
        stats_line = None
        while time.time() - t0 < 30 and stats_line is None:
            line = proc.stdout.readline()
            if line.startswith("[stats]"):
                stats_line = line
        assert stats_line and "tok/s" in stats_line and "tokens=4" in stats_line
        # a client that connects and never sends its request is cut after
        # ServerConfig.drain_timeout (5 s); it cannot hold the stop
        silent = socket.create_connection((HOST, port))
        time.sleep(0.2)
        t_sig = time.time()
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=60)
        stop_s = time.time() - t_sig
        silent.close()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert "server closed" in out and stop_s < 30
    assert "Traceback" not in out and "KeyboardInterrupt" not in out
    events = [json.loads(ln)["event"] for ln in trace_log.read_text().splitlines()]
    assert events.count("submit") == events.count("finish") == 1
    assert "retrace" not in events


def test_serve_without_a_card_raises(monkeypatch):
    """No CPU fallback: the HTTP mode needs ``--device cpu`` on a host
    without a card, as the batch mode does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDeviceError):
        serve_cli.main(["--reduced", "--serve", "--port", "0"])


def test_stats_interval_must_not_be_negative():
    with pytest.raises(SystemExit, match="--stats-interval must be >= 0"):
        serve_cli.main(["--reduced", "--device", "cpu", "--serve",
                        "--stats-interval", "-1"])
