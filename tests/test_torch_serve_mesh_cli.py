"""The serve CLI's ``--mesh DPxTP`` on the CPU: two gloo ranks started by
``torch.distributed.run`` serve granite-8b ``.reduced()`` (and the
encoder-decoder seamless-m4t-large-v2, its tiled layers on the same
per-shard path) tensor-parallel and print the single-device run's
tokens; the first rank alone reports (the backend and why, the mesh's
tile bytes). ``--aot`` warms both ranks up and gives the same tokens;
``--serve`` runs the HTTP shell on the first rank, which alone prints the
readiness line, streams a request, and on a SIGINT to that rank closes,
stops the follower and lets every rank exit 0. A mesh the job's ranks do
not fill and a malformed one are refused before anything is built."""
import asyncio
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from repro_torch.launch import serve as serve_cli
from repro_torch.serve.client import sse_generate

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--reduced", "--device", "cpu", "--requests", "3", "--max-tokens", "4",
        "--max-len", "48", "--no-telemetry"]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
TORCHRUN = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "2", "-m", "repro_torch.launch.serve"]


def _token_lines(text):
    return re.findall(r"^  req \d+: prompt\[\d+\] -> \[.*\]$", text, re.M)


def _two_ranks(args):
    return subprocess.run(TORCHRUN + args, capture_output=True, text=True,
                          env=ENV, cwd=ROOT, timeout=120)


@pytest.mark.parametrize("arch", ["granite-8b", "seamless-m4t-large-v2"])
def test_mesh_cli_two_ranks_match_single_device(capsys, arch):
    args = ARGS + ["--arch", arch, "--enc-tokens", "16"]
    out = _two_ranks(args + ["--mesh", "1x2"])
    assert out.returncode == 0, out.stderr[-3000:]
    text = out.stdout
    assert text.count("backend=gloo (2 ranks on the CPU)") == 1, text
    assert re.search(r"mesh=\{'data': 1, 'model': 2\}: tile bits [\d.]+MB total, "
                     r"[\d.]+MB max/device \(2\.0x sharding\)", text), text
    serve_cli.main(args)
    single = capsys.readouterr().out
    assert _token_lines(text) == _token_lines(single) and len(_token_lines(text)) == 3


def test_mesh_cli_aot_warms_every_rank(capsys):
    """``--mesh 1x2 --aot``: both ranks capture their ticks (the first
    prints the warmup line), exit 0, and the tokens are one device's."""
    out = _two_ranks(ARGS + ["--mesh", "1x2", "--aot"])
    assert out.returncode == 0, out.stderr[-3000:]
    text = out.stdout
    assert len(re.findall(r"^AOT warmup: decode_tick \d+\.\d\ds, extend_tick "
                          r"\d+\.\d\ds$", text, re.M)) == 1, text
    serve_cli.main(ARGS)
    single = capsys.readouterr().out
    assert _token_lines(text) == _token_lines(single) and len(_token_lines(text)) == 3


def test_mesh_cli_serve_on_the_first_rank():
    """``--mesh 1x2 --serve --port 0``: one readiness line (the first
    rank's), one SSE stream with one device's tokens, then SIGINT to the
    first rank: it closes, stops the follower, and the job exits 0."""
    proc = subprocess.Popen(
        TORCHRUN + ARGS + ["--mesh", "1x2", "--serve", "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=ENV,
        cwd=ROOT)
    try:
        lines, port, pid = [], None, None
        t0 = time.time()
        while time.time() - t0 < 120 and port is None:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if m := re.match(r"first rank 0 \(pid (\d+)\) serves, 1 follow", line):
                pid = int(m.group(1))
            if line.startswith("serving on http://"):
                port = int(line.split(":")[2].split()[0])
        assert port and pid, "".join(lines)
        assert lines[-1].strip().endswith("(aot=on)")
        st, ev, _ = asyncio.run(sse_generate("127.0.0.1", port, {
            "prompt": [1, 2, 3], "max_tokens": 4}))
        os.kill(pid, signal.SIGINT)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    text = "".join(lines) + out
    assert proc.returncode == 0, text[-3000:]
    assert text.count("serving on http://") == 1 and "server closed" in text
    assert "Traceback" not in text
    assert st == 200 and ev[-1]["finish_reason"] == "length"
    tokens = [e["token"] for e in ev if "token" in e]
    assert len(tokens) == 4 and tokens == _single_tokens([1, 2, 3], 4)


def _single_tokens(prompt, n):
    """One device's greedy tokens for ``prompt`` with the CLI's export and
    engine shape."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.serve.engine import BatchedEngine, ServeConfig
    from repro_torch.serve.sampling import SamplingParams

    cfg = get_config("granite-8b").reduced()
    s_model, sp, _ = serve_cli.build_serving(cfg, device="cpu", seed=0)
    eng = BatchedEngine(s_model, sp, ServeConfig(n_slots=4, max_len=48,
                                                 chunk_tokens=32, page_tokens=16,
                                                 prefix_cache=True))
    req = eng.submit(np.asarray(prompt, np.int32), SamplingParams(max_tokens=n))
    eng.run_until_drained()
    return req.output


@pytest.mark.parametrize("extra, match", [
    (["--mesh", "1x4"], "needs 4 devices, have 2 ranks"),
    (["--mesh", "2by2"], "--mesh wants DPxTP"),
    (["--mesh", "0x2"], "--mesh dims must be >= 1"),
])
def test_mesh_cli_refusals(monkeypatch, extra, match):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match=re.escape(match)):
        serve_cli.main(ARGS + extra)
