"""Batched serving CLI with packed-tile weights and chunked prefill (port
of the synthetic-batch mode of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \\
        --requests 8 --max-tokens 16 --chunk-tokens 32

runs on the GPU (kernels B1/B2); ``--device cpu`` runs the plain PyTorch
versions on the host instead (there is no silent fallback: without a card
and without ``--device cpu`` the CLI raises).

Flow: init the TRAIN masters on the device, export the SERVE form (packed
tile rows + alpha), stand up the ``BatchedEngine`` and drain a batch of
synthetic prompts, timing every tick. Prints the compression of the
shipped weights, the throughput, a TTFT / inter-token-latency line, and
the first requests' tokens.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ArchConfig, build_model, get_config
from repro_torch.device import resolve_device
from repro_torch.nn.context import SERVE, TRAIN, ModelContext
from repro_torch.serve.engine import BatchedEngine, ServeConfig
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.weights import export_serving_params, serving_bytes


def device_label(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device).upper()


def build_serving(cfg: ArchConfig, *, device, seed: int,
                  compute_dtype=torch.bfloat16):
    """Random TRAIN masters from ``seed`` -> (SERVE model, SERVE params,
    master bytes). The masters are freed before returning."""
    t_model = build_model(cfg, ModelContext(
        policy=cfg.tbn, mode=TRAIN, compute_dtype=compute_dtype, device=device))
    s_model = build_model(cfg, ModelContext(
        policy=cfg.tbn, mode=SERVE, compute_dtype=compute_dtype, device=device))
    masters = t_model.init(seed)
    master_b = serving_bytes(masters)
    with torch.no_grad():
        sp = export_serving_params(t_model.specs(), s_model.specs(), masters,
                                   cfg.tbn)
    del masters
    if s_model.device.type == "cuda":
        torch.cuda.empty_cache()
    return s_model, sp, master_b


def synthetic_prompts(rng: np.random.Generator, n: int, vocab: int,
                      lo: int = 3, hi: int = 12):
    """``n`` random prompts of lo <= length < hi tokens."""
    return [rng.integers(0, vocab, size=int(rng.integers(lo, hi))).astype(np.int32)
            for _ in range(n)]


def latency_report(reqs, tick_ends):
    """Per-request TTFT and inter-token latencies from the engine's
    token_steps tick indices + the caller's per-tick wall clock
    (tick_ends[i] = cumulative wall time at the end of tick i)."""
    ttfts, itls = [], []
    for r in reqs:
        if not r.token_steps:
            continue
        ttfts.append(tick_ends[r.token_steps[0]])
        for a, b in zip(r.token_steps, r.token_steps[1:]):
            itls.append(tick_ends[b] - tick_ends[a])
    return ttfts, itls


def drain(eng: BatchedEngine, reqs):
    """Run the engine until drained; returns (ticks, seconds, tick_ends)."""
    t0 = time.perf_counter()
    tick_ends = []
    ticks = eng.run_until_drained(
        on_tick=lambda _: tick_ends.append(time.perf_counter() - t0))
    return ticks, (tick_ends[-1] if tick_ends else 0.0), tick_ends


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--chunk-tokens", type=int, default=32,
                    help="prefill chunk width == per-tick token budget "
                         "(clamped to --max-len)")
    ap.add_argument("--page-tokens", type=int, default=16,
                    help="attention KV pool page size (must divide --max-len)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    if args.max_len < 12:
        raise SystemExit(f"--max-len {args.max_len} is below the longest "
                         f"synthetic prompt (11 tokens)")

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    s_model, sp, master_b = build_serving(cfg, device=device, seed=args.seed)
    ship_b = serving_bytes(sp)
    print(f"arch={cfg.name} TBN p={cfg.tbn.p}: masters {master_b / 1e6:.2f}MB "
          f"-> shipped {ship_b / 1e6:.2f}MB ({master_b / ship_b:.1f}x smaller)")

    eng = BatchedEngine(s_model, sp, ServeConfig(
        n_slots=args.slots, max_len=args.max_len,
        chunk_tokens=min(args.chunk_tokens, args.max_len),
        temperature=args.temperature, top_k=args.top_k, seed=args.seed,
        page_tokens=args.page_tokens))
    rng = np.random.default_rng(args.seed)
    reqs = [eng.submit(p, SamplingParams(max_tokens=args.max_tokens))
            for p in synthetic_prompts(rng, args.requests, cfg.vocab)]
    ticks, dt, tick_ends = drain(eng, reqs)
    tok = sum(len(r.output) for r in reqs)
    label = device_label(device)
    rate = f"{tok / dt:.1f} tok/s on {label}" if dt > 1e-9 else "instant drain"
    print(f"{len(reqs)} requests, {tok} tokens in {ticks} engine ticks, "
          f"{dt:.2f}s ({rate})")
    ttfts, itls = latency_report(reqs, tick_ends)
    if ttfts:
        line = (f"TTFT mean {1e3 * np.mean(ttfts):.1f}ms "
                f"max {1e3 * np.max(ttfts):.1f}ms")
        if itls:
            line += (f" | ITL mean {1e3 * np.mean(itls):.1f}ms "
                     f"max {1e3 * np.max(itls):.1f}ms")
        print(f"latency on {label} (chunk={eng.cfg.chunk_tokens}): {line}")
    for r in reqs[:3]:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.output}")
    return reqs


if __name__ == "__main__":
    main()
