#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py          # from the root of a checkout

Phases (any failure raises and exits non-zero; no phase is skipped):
  1. print the card's name and power limit, build kernels B1/B2 from
     ``src/repro_torch/csrc`` (one nvcc per source, in parallel);
  2. kernel vs plain version on the card at the (K, r) pairs of the
     full-width granite-8b path, bf16 and f32: B1 at m in {1, 4, 32}, B2 at
     m in {33, 128, 512}; each call compared at rtol=1e-4,
     atol=1e-4*max|u_ref| (x*±1 is exact in f32, so only the summation
     order differs) and timed beside the plain version, ``torch.matmul`` on
     the pre-unpacked ±1 tile (a yardstick the port never calls) and the
     data-sheet bound;
  3. serve granite-8b at its published width through the user entry points
     (masters from a seed -> export -> BatchedEngine): 8 requests, prompts
     of 3-100 tokens, 16 greedy tokens each, 4 slots, 32-token chunks,
     16-token pages; asserts that both kernels' launch counters rose on
     this path alone; then traces three decode-only ticks with
     torch.profiler (device busy time vs the tick's wall time, top kernels);
  4. the same exported weights at full width, 2 layers, f32: one extend and
     one decode_step on the card (kernels) against the CPU model (plain
     versions), logits at rtol=atol=1e-3 (attention softmax and norms also
     reorder sums).

The line before the last is a JSON object with one entry per kernel; the
last line is the JSON status line.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# (name, K, r) of every tiled matmul of a full-width granite-8b layer, and
# how many times one layer calls it; the LM head runs once per tick.
SHAPES = (("q/o", 4096, 512, 2), ("k/v", 4096, 128, 2),
          ("gate/up", 4096, 1792, 2), ("down", 14336, 512, 1),
          ("lm_head", 4096, 6144, 0))
B1_MS = (1, 4, 32)
B2_MS = (33, 128, 512)
N_SLOTS, CHUNK = 4, 32
RTOL = 1e-4
# Data-sheet peaks (dense): memory bytes/s, bf16 tensor-core flop/s, f32
# (non-tensor) flop/s; picked by the name nvidia-smi reports.
PEAKS = {"SXM": (3.35e12, 989e12, 67e12), "PCIe": (2.0e12, 756e12, 51e12),
         "NVL": (3.9e12, 835e12, 60e12)}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def peaks(card: str):
    for key in ("PCIe", "NVL"):
        if key in card:
            return PEAKS[key]
    return PEAKS["SXM"]


def time_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time of one ``fn()`` call: ``iters`` calls captured in a CUDA
    graph, replayed ``reps`` times between CUDA events (launch overhead on
    the host is not in the number)."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def check_kernel(kernel, plain, x, packed, bw, peak):
    """Run ``kernel`` once against ``plain`` on the same card inputs, assert
    the tolerance and that the launch counter rose, then time both and the
    library yardstick. Returns a dict of the measurements."""
    import torch

    from repro_torch.kernels.tiled_matmul import unpack_rows

    before = kernel.launches
    got = kernel(x, packed)
    torch.cuda.synchronize()
    if kernel.launches != before + 1:
        fail(f"{kernel.__name__} did not count its launch")
    want = plain(x, packed)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=RTOL, atol=RTOL * scale):
        fail(f"{kernel.__name__} m={x.shape[0]} K={x.shape[1]} r={packed.shape[0]} "
             f"{x.dtype}: max|err| {err:.3e} over tolerance (max|u| {scale:.3e})")
    dense = unpack_rows(packed).to(x.dtype)
    m, k = x.shape
    r = packed.shape[0]
    nbytes = x.numel() * x.element_size() + packed.numel() * 4 + m * r * 4
    flops = 2.0 * m * k * r
    t_bytes, t_ops = 1e3 * nbytes / bw, 1e3 * flops / peak
    return dict(
        err=err, scale=scale,
        ms=time_ms(lambda: kernel(x, packed)),
        plain_ms=time_ms(lambda: plain(x, packed)),
        library_ms=time_ms(lambda: torch.matmul(x, dense.T)),
        bound_ms=max(t_bytes, t_ops), bytes_ms=t_bytes, ops_ms=t_ops)


def phase_kernels(card: str):
    """Phase 2. Returns {(kernel, m, dtype, shape): measurements}."""
    import torch

    from repro_torch.kernels.tiled_matmul import tiled_matmul_plain, tiled_matmul_unique
    from repro_torch.kernels.tiled_matvec import tiled_matvec_plain, tiled_matvec_unique

    bw, bf16_peak, f32_peak = peaks(card)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    results = {}
    for kname, kernel, plain, ms in (
            ("B1", tiled_matvec_unique, tiled_matvec_plain, B1_MS),
            ("B2", tiled_matmul_unique, tiled_matmul_plain, B2_MS)):
        for name, k, r, _ in SHAPES:
            packed = torch.randint(0, 2**32, (r, k // 32), generator=gen,
                                   device="cuda", dtype=torch.int64).to(torch.int32)
            for dtype, peak in ((torch.bfloat16, bf16_peak), (torch.float32, f32_peak)):
                for m in ms:
                    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
                    res = check_kernel(kernel, plain, x, packed, bw, peak)
                    results[(kname, m, str(dtype).split(".")[-1], name)] = res
                    print(f"{kname} {name:8s} K={k:5d} r={r:4d} m={m:3d} "
                          f"{str(dtype).split('.')[-1]:8s} max|err|={res['err']:.2e} "
                          f"(max|u|={res['scale']:.1f}) kernel {res['ms']:.4f}ms "
                          f"plain {res['plain_ms']:.4f}ms library "
                          f"{res['library_ms']:.4f}ms bound {res['bound_ms']:.4f}ms",
                          flush=True)
    return results


def tick_totals(results, kname: str, m: int, n_layers: int, with_head: bool):
    """Sum the per-shape measurements over the calls of one engine tick."""
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               bytes_ms=0.0, ops_ms=0.0)
    for name, _, _, per_layer in SHAPES:
        n = per_layer * n_layers + (1 if name == "lm_head" and with_head else 0)
        res = results[(kname, m, "bfloat16", name)]
        for key in tot:
            tot[key] += n * res[key]
    return tot


def phase_serve(cfg):
    """Phase 3: granite-8b at published width through the entry points."""
    import numpy as np
    import torch

    from repro_torch.kernels.tiled_matmul import tiled_matmul_unique
    from repro_torch.kernels.tiled_matvec import tiled_matvec_unique
    from repro_torch.launch.serve import build_serving, drain, latency_report, synthetic_prompts
    from repro_torch.serve.engine import BatchedEngine, ServeConfig
    from repro_torch.serve.sampling import SamplingParams
    from repro_torch.serve.weights import serving_bytes

    t0 = time.perf_counter()
    s_model, sp, master_b = build_serving(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    ship_b = serving_bytes(sp)
    print(f"serve {cfg.name}: L={cfg.n_layers} d={cfg.d_model} heads={cfg.n_heads}/"
          f"{cfg.n_kv} d_ff={cfg.d_ff} vocab={cfg.vocab} p={cfg.tbn.p} bf16: masters "
          f"{master_b / 1e9:.2f}GB -> shipped {ship_b / 1e9:.3f}GB in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    eng = BatchedEngine(s_model, sp, ServeConfig(
        n_slots=N_SLOTS, max_len=128, chunk_tokens=CHUNK, page_tokens=16))
    rng = np.random.default_rng(0)
    reqs = [eng.submit(p, SamplingParams(max_tokens=16))
            for p in synthetic_prompts(rng, 8, cfg.vocab, 3, 101)]
    tiled_matvec_unique.launches = 0
    tiled_matmul_unique.launches = 0
    ticks, dt, tick_ends = drain(eng, reqs)
    b1, b2 = tiled_matvec_unique.launches, tiled_matmul_unique.launches
    st = eng.stats()
    tok = sum(len(r.output) for r in reqs)
    if not all(r.done and len(r.output) == 16 for r in reqs):
        fail("not every request finished with 16 tokens")
    if not all(0 <= t < cfg.vocab for r in reqs for t in r.output):
        fail("a sampled token is outside the vocabulary")
    need_b1 = (7 * cfg.n_layers + 1) * st["decode_ticks"] + st["extend_ticks"]
    if st["decode_ticks"] == 0 or st["extend_ticks"] == 0:
        fail(f"the run had {st['decode_ticks']} decode and {st['extend_ticks']} "
             f"extend ticks; both paths must run")
    if b1 < need_b1 or b2 < st["extend_ticks"]:
        fail(f"launch counters B1={b1} (need >= {need_b1}), B2={b2} (need >= "
             f"{st['extend_ticks']}): the main path did not go through the kernels")
    ttfts, itls = latency_report(reqs, tick_ends)
    print(f"serve: {len(reqs)} requests, {tok} tokens in {ticks} ticks "
          f"({st['extend_ticks']} extend, {st['decode_ticks']} decode), {dt:.3f}s, "
          f"{tok / dt:.1f} tok/s | TTFT mean {1e3 * np.mean(ttfts):.1f}ms max "
          f"{1e3 * np.max(ttfts):.1f}ms | ITL mean {1e3 * np.mean(itls):.2f}ms max "
          f"{1e3 * np.max(itls):.2f}ms | extend tick {st['extend_ms_mean']:.2f}ms "
          f"decode tick {st['decode_ms_mean']:.2f}ms | launches B1={b1} B2={b2}",
          flush=True)
    print(f"serve: first requests' tokens {[r.output for r in reqs[:2]]}")
    profile_decode(s_model, sp, cfg, st["decode_ms_mean"])
    return sp, {"B1": b1, "B2": b2}


def profile_decode(s_model, sp, cfg, tick_ms: float, n_ticks: int = 3):
    """Trace ``n_ticks`` decode-only ticks with torch.profiler: device busy
    time per tick (sum of kernel durations; one stream, so no overlap) beside
    the unprofiled decode tick of the serve run, and the top kernels."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import BatchedEngine, ServeConfig
    from repro_torch.serve.sampling import SamplingParams

    eng = BatchedEngine(s_model, sp, ServeConfig(
        n_slots=N_SLOTS, max_len=128, chunk_tokens=CHUNK, page_tokens=16))
    rng = np.random.default_rng(2)
    for _ in range(N_SLOTS):   # 4 x 8 prompt tokens: one extend tick
        eng.submit(rng.integers(0, cfg.vocab, size=8),
                   SamplingParams(max_tokens=n_ticks + 3))
    eng.step()
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_ticks):
            eng.step()
        torch.cuda.synchronize()
    if eng.stats()["extend_ticks"] != 1:
        fail("the profiled ticks were not decode-only")
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n_ticks
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
    if not kernels:
        print("profile: the profiler recorded no device events (device time "
              "not measured)")
        return
    print(f"profile: decode tick device busy {busy_ms:.3f} ms of "
          f"{tick_ms:.2f} ms wall (serve run) -> device idle share "
          f"{1 - busy_ms / tick_ms:.3f}; {len(kernels) / n_ticks:.0f} kernels/tick")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
        print(f"  {t / n_ticks:8.3f} ms/tick {n // n_ticks:5d}x  {name[:90]}")


def phase_card_vs_cpu(cfg, sp):
    """Phase 4: full width, 2 layers, f32, card model vs CPU model."""
    import numpy as np
    import torch

    from repro_torch.configs import build_model
    from repro_torch.nn import module as mod
    from repro_torch.nn.context import SERVE, ModelContext

    cfg2 = dataclasses.replace(cfg, n_layers=2)
    sp2 = dict(sp, seg0=mod.map_tree(lambda v: v[:2].contiguous(), sp["seg0"]))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, size=(2, 24))
    nxt = rng.integers(0, cfg.vocab, size=(2, 1))
    out = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg2, ModelContext(policy=cfg.tbn, mode=SERVE,
                                               compute_dtype=torch.float32,
                                               device=dev))
        params = mod.map_tree(lambda v: v.to(dev), sp2)
        caches = model.init_caches(8, 16, torch.float32)
        ptab = torch.arange(8, dtype=torch.int32, device=dev).reshape(2, 4)
        lengths = torch.zeros(2, dtype=torch.int32, device=dev)
        n_new = torch.tensor([24, 17], dtype=torch.int32, device=dev)
        with torch.no_grad():
            le, caches, lengths = model.extend(
                params, torch.from_numpy(tokens).to(dev), caches, lengths,
                n_new, ptab)
            ld, _, _ = model.decode_step(params, torch.from_numpy(nxt).to(dev),
                                         caches, lengths, ptab)
        out[dev] = (le.cpu(), ld.cpu())
    errs = []
    for name, a, b in zip(("extend", "decode"), out["cuda"], out["cpu"]):
        if not torch.isfinite(a).all():
            fail(f"card {name} logits are not finite")
        errs.append(float((a - b).abs().max()))
        if not torch.allclose(a, b, rtol=1e-3, atol=1e-3):
            fail(f"card vs CPU {name} logits differ: max|diff| {errs[-1]:.3e}")
    print(f"model card vs CPU (L=2, full width, f32): extend max|diff| "
          f"{errs[0]:.2e}, decode max|diff| {errs[1]:.2e} (rtol=atol=1e-3) OK")


def main() -> None:
    try:
        import torch
    except ImportError as e:
        fail(f"PyTorch is not installed: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: chip_smoke needs one CUDA GPU")
    try:
        from repro_torch.configs import get_config
        from repro_torch.kernels import _build
    except ImportError as e:
        fail(f"cannot import repro_torch from {ROOT / 'src'}: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 means f32 here
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    _build.build()
    print(f"kernel build: {time.perf_counter() - t0:.1f}s", flush=True)
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    results = phase_kernels(card)
    cfg = get_config("granite-8b")
    sp, launches = phase_serve(cfg)
    phase_card_vs_cpu(cfg, sp)

    entries = []
    for kname, fname, m, head, replaces in (
            ("B1", "tiled_matvec", N_SLOTS, True,
             "src/repro/kernels/tiled_matvec.py:97"),
            ("B2", "tiled_matmul", N_SLOTS * CHUNK, False,
             "src/repro/kernels/tiled_matmul.py:69")):
        tot = tick_totals(results, kname, m, cfg.n_layers, head)
        entries.append({
            "name": fname, "route": "cuda",
            "source": f"src/repro_torch/csrc/{fname}.cu", "replaces": replaces,
            "launches": launches[kname],
            "max_abs_err": max(v["err"] for key, v in results.items()
                               if key[0] == kname),
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": "operations" if tot["ops_ms"] >= tot["bytes_ms"] else "bytes",
            "library_ms": tot["library_ms"],
            "per": f"one {'decode' if head else 'extend'} tick at L={cfg.n_layers}, "
                   f"m={m}, bf16",
        })
    print(f"card: {card_line()}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
