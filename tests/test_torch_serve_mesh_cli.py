"""The serve CLI's ``--mesh DPxTP`` on the CPU: two gloo ranks started by
``torch.distributed.run`` serve granite-8b ``.reduced()`` (and the
encoder-decoder seamless-m4t-large-v2, its tiled layers on the same
per-shard path) tensor-parallel and print the single-device run's
tokens; the first rank alone reports (the backend and why, the mesh's
tile bytes); ``--serve``, ``--aot``, a mesh the job's ranks do not fill
and a malformed one are refused before anything is built."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.launch import serve as serve_cli
from repro_torch.serve.engine import MESH_GRAPH_ITEM

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--reduced", "--device", "cpu", "--requests", "3", "--max-tokens", "4",
        "--max-len", "48", "--no-telemetry"]


def _token_lines(text):
    return re.findall(r"^  req \d+: prompt\[\d+\] -> \[.*\]$", text, re.M)


@pytest.mark.parametrize("arch", ["granite-8b", "seamless-m4t-large-v2"])
def test_mesh_cli_two_ranks_match_single_device(capsys, arch):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    args = ARGS + ["--arch", arch, "--enc-tokens", "16"]
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve", *args,
         "--mesh", "1x2"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    text = out.stdout
    assert text.count("backend=gloo (2 ranks on the CPU)") == 1, text
    assert re.search(r"mesh=\{'data': 1, 'model': 2\}: tile bits [\d.]+MB total, "
                     r"[\d.]+MB max/device \(2\.0x sharding\)", text), text
    serve_cli.main(args)
    single = capsys.readouterr().out
    assert _token_lines(text) == _token_lines(single) and len(_token_lines(text)) == 3


@pytest.mark.parametrize("extra, match", [
    (["--mesh", "1x2", "--serve"], MESH_GRAPH_ITEM),
    (["--mesh", "1x2", "--aot"], MESH_GRAPH_ITEM),
    (["--mesh", "1x4"], "needs 4 devices, have 2 ranks"),
    (["--mesh", "2by2"], "--mesh wants DPxTP"),
    (["--mesh", "0x2"], "--mesh dims must be >= 1"),
])
def test_mesh_cli_refusals(monkeypatch, extra, match):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match=re.escape(match)):
        serve_cli.main(ARGS + extra)
