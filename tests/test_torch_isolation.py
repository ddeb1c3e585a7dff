"""The port stands alone and keeps the device rule.

* No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports
  ``jax`` or the JAX package ``repro`` (``repro_torch`` itself is fine).
* Every module imports with ``jax`` and ``repro`` made unimportable.
* Entry points run on CUDA unless the caller asks for the CPU: without a
  card they raise instead of falling back.
"""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import build_model, get_config
from repro_torch.device import NoCudaDeviceError, resolve_device
from repro_torch.launch import serve as serve_cli
from repro_torch.nn.context import SERVE, ModelContext
from repro_torch.serve.engine import BatchedEngine, ServeConfig

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.relative_to(ROOT)}:{node.lineno} imports {bad}"


def test_every_module_imports_without_jax_or_reference():
    code = (
        "import sys, importlib, pkgutil\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_is_cuda_and_never_falls_back(no_cuda):
    with pytest.raises(NoCudaDeviceError):
        resolve_device()
    with pytest.raises(NoCudaDeviceError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    cfg = get_config("granite-8b").reduced()
    with pytest.raises(NoCudaDeviceError):
        build_model(cfg)
    with pytest.raises(NoCudaDeviceError):
        ModelContext(policy=cfg.tbn, mode=SERVE)
    with pytest.raises(NoCudaDeviceError):
        serve_cli.main(["--reduced", "--requests", "1"])


def test_engine_runs_where_its_model_runs(no_cuda):
    cfg = get_config("granite-8b").reduced()
    sm = build_model(cfg, ModelContext(policy=cfg.tbn, mode=SERVE, device="cpu"))
    sp = sm.init(0)
    eng = BatchedEngine(sm, sp, ServeConfig(n_slots=1, max_len=16,
                                            chunk_tokens=8, page_tokens=8))
    assert eng.device == torch.device("cpu")
    bad = dict(sp, embed={"table": sp["embed"]["table"].to("meta")})
    with pytest.raises(ValueError, match="embed/table"):
        BatchedEngine(sm, bad, ServeConfig(n_slots=1, max_len=16,
                                           chunk_tokens=8, page_tokens=8))


def test_cli_runs_on_cpu_when_asked(capsys):
    reqs = serve_cli.main(["--reduced", "--device", "cpu", "--requests", "2",
                           "--max-tokens", "3", "--max-len", "32"])
    out = capsys.readouterr().out
    assert "tok/s on CPU" in out and "TTFT" in out
    assert all(len(r.output) == 3 for r in reqs)
    assert all(0 <= t < 512 for r in reqs for t in r.output)
    assert np.isfinite([len(r.prompt) for r in reqs]).all()
