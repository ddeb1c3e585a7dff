"""What the toolkit and the card make of the 1-bit tensor-core form.

    python -m repro_torch.kernels.bmma_probe

Compiles ``csrc/bmma_probe.cu`` for ``sm_90a`` twice, with the AND and the
XOR form of ``mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.*.popc``,
and prints for each form: whether ``nvcc`` accepts it (with its message
if not), the tensor-core instructions ``cuobjdump --dump-sass`` finds in
the library, whether one tile agrees with ``popcount(A op B)`` under the
fragment layout kernel B3's tensor-core body uses, and the issue rate and
dependent latency of a tight loop of it beside the s8 m16n8k32 ``IMMA``
(CUDA events around one launch on every SM). Needs the card and ``nvcc``;
the card's name and power limit head the output.
"""
from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
from collections import Counter

import numpy as np
import torch

from repro_torch.kernels import _build

FORMS = {"and": [], "xor": ["-DPROBE_XOR"]}
# 2 * m * n * k of one instruction: b1 m16n8k256, s8 m16n8k32
OPS = {"b1": 2 * 16 * 8 * 256, "s8": 2 * 16 * 8 * 32}


def compile_form(form: str):
    """(library path or None, nvcc's output) of one form."""
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"bmma_probe_{form}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *FORMS[form], "-o", str(lib),
           str(_build.CSRC / "bmma_probe.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    text = (proc.stdout + proc.stderr).strip()
    return (lib if proc.returncode == 0 else None), text


def sass_mma(lib) -> Counter:
    """Counts of the SASS opcodes (with modifiers) of every MMA line."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", str(lib)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    ops = Counter()
    for line in sass.splitlines():
        hit = re.search(r"\b([A-Z]*MMA[.\w]*)", line)
        if hit:
            ops[hit.group(1)] += 1
    return ops


def check_tile(fn, form: str) -> str:
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, (16, 8), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, (8, 8), dtype=np.uint64).astype(np.uint32)
    op = np.bitwise_and if form == "and" else np.bitwise_xor
    bits = np.unpackbits(op(a[:, None, :], b[None, :, :]).view(np.uint8), axis=-1)
    want = bits.reshape(16, 8, -1).sum(-1)
    ta = torch.from_numpy(a.view(np.int32)).cuda()
    tb = torch.from_numpy(b.view(np.int32)).cuda()
    c = torch.zeros((16, 8), dtype=torch.int32, device="cuda")
    err = fn(ta.data_ptr(), tb.data_ptr(), c.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if err:
        return f"launch error {err}"
    got = c.cpu().numpy()
    return "equal" if np.array_equal(got, want) else (
        f"DIFFERS in {int((got != want).sum())} of 128 entries")


def time_loop(fn, kind: int, blocks: int, threads: int, iters: int) -> float:
    """ms of one launch of the loop kernel (median of 5)."""
    out = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    times = []
    for _ in range(6):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        err = fn(kind, blocks, threads, iters, out.data_ptr(), stream)
        end.record()
        torch.cuda.synchronize()
        if err:
            raise RuntimeError(f"probe_loop kind {kind}: CUDA error {err}")
        times.append(start.elapsed_time(end))
    return float(np.median(times[1:]))


def main() -> None:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()[-1]
    print(f"nvcc: {nvcc}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60).stdout.strip()
    print(f"SMs: {sms}; SM clock now, max: {clock}")
    for form in FORMS:
        lib, text = compile_form(form)
        if lib is None:
            print(f"[{form}.popc] nvcc REFUSES it for sm_90a:\n  "
                  + "\n  ".join(text.splitlines()[-6:]))
            continue
        warn = [l for l in text.splitlines() if "warn" in l.lower()]
        print(f"[{form}.popc] nvcc accepts it for sm_90a"
              + (f"; warnings: {warn[:3]}" if warn else ""))
        print(f"[{form}.popc] SASS MMA opcodes: {dict(sass_mma(lib))}")
        so = ctypes.CDLL(str(lib))
        so.probe_tile.argtypes = [ctypes.c_void_p] * 4
        so.probe_tile.restype = ctypes.c_int
        so.probe_loop.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
        so.probe_loop.restype = ctypes.c_int
        print(f"[{form}.popc] one m16n8k256 tile vs numpy popcount(A {form} B): "
              f"{check_tile(so.probe_tile, form)}")
        blocks, threads, iters = 4 * sms, 256, 4096
        for name, kind, ops in (("b1 m16n8k256", 0, OPS["b1"]),
                                ("s8 m16n8k32", 2, OPS["s8"])):
            ms = time_loop(so.probe_loop, kind, blocks, threads, iters)
            n = blocks * threads // 32 * iters * 8
            lat = time_loop(so.probe_loop, kind + 1, 1, 32, iters)
            print(f"[{form}.popc] {name}: {n / ms / 1e6:.1f} G instr/s on {sms} SMs "
                  f"({n / ms / 1e3 / sms:.1f} M instr/s/SM, {ops * n / ms / 1e9:.1f} "
                  f"T op/s as 2*m*n*k) | dependent latency "
                  f"{lat / iters * 1e6:.1f} ns/instr ({iters} in {lat:.3f} ms)")


if __name__ == "__main__":
    main()
