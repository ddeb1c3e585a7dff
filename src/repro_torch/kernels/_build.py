"""Build and bind the port's CUDA kernels: ``nvcc`` -> shared library ->
``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into
``build/kernels/<name>-<hash>.so`` at the repository root, where the hash
covers the source bytes, every shared header ``csrc/*.cuh`` and the
compiler flags, so an edited kernel or header is rebuilt and an unchanged
one is reused. :func:`build` starts one ``nvcc`` per missing library and
waits for all of them, so a cold start costs the slowest compile, not the
sum. Sources have a plain C interface (pointers, ints, the stream) and
include only the CUDA toolkit, which keeps each compile to seconds;
``cuTensorMapEncodeTiled``, which encodes B2's and B6's TMA descriptors,
is fetched at run time through ``cudaGetDriverEntryPoint``, so no library
links ``libcuda``.

Nothing here runs at import: the CPU tests import every module of the
package on a host that has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("tiled_matvec", "tiled_matmul", "tiled_xnor", "tiled_int8",
           "tile_construct", "tiled_conv", "seq_attend")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """``nvcc`` failed (or is missing); the message carries its output."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelBuildError(
        "nvcc not found on PATH or under /usr/local/cuda/bin: the CUDA "
        "kernels are compiled on the machine that has the GPU")


def lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """The compiler output (``-Xptxas=-v``: registers, shared memory,
    spills) of the last build of ``name``, or "" if it was never built."""
    log = BUILD_DIR / f"{name}.log"
    return log.read_text() if log.exists() else ""


def build(names: Iterable[str] = SOURCES) -> None:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` process per source, all started together."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        final = lib_path(name)
        if final.exists():
            continue
        tmp = final.with_name(f"{final.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, final))
    failed = []
    for name, proc, tmp, final in jobs:
        out, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, final)    # atomic: a reader never sees half a .so
    if failed:
        raise KernelBuildError("kernel build failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use.

    Every library exports ``const char* tbn_error_string(int)`` beside its
    launch function."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            lib.tbn_error_string.argtypes = [ctypes.c_int]
            lib.tbn_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        msg = lib.tbn_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
