"""Batched serving CLI with packed-tile weights and chunked prefill (port
of the synthetic-batch mode of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \\
        --requests 8 --max-tokens 16 --chunk-tokens 32

runs on the GPU (kernels B1/B2); ``--device cpu`` runs the plain PyTorch
versions on the host instead (there is no silent fallback: without a card
and without ``--device cpu`` the CLI raises). ``--compute-path xnor`` or
``int8`` serves the decode ticks through the integer kernels B3 / B4.
``--aot`` warms the engine up before the first request: its decode and
extend ticks are captured as CUDA graphs and replayed from then on (on the
CPU: one eager run of each, no graph).

``--arch`` takes every id the port registers: the dense family
(granite-8b, minitron-8b, starcoder2-7b, qwen1.5-32b with its int8 KV
cache), the MoE family (qwen2-moe-a2.7b, moonshot-v1-16b-a3b), the SSM
family (mamba2-370m), the hybrid family (recurrentgemma-2b), the VLM
family (chameleon-34b, token prompts) and the encoder-decoder family
(seamless-m4t-large-v2); a model without full attention gets no page
pool, and ``--aot`` then captures the slot reset too. An encoder-decoder
request carries a synthetic source clip of enc_tokens / 2 to
``--enc-tokens`` frames (``--enc-sources`` distinct clips, cycled over
the requests) that the engine encodes before its prompt prefills; ``--aot``
then captures the encode tick too. ``--reduced`` serves its tiny
same-family config.

Flow: build the TRAIN masters on the device one leaf at a time, export
each to the SERVE form (packed tile rows + alpha) and free it, stand up
the ``BatchedEngine`` and drain a batch of synthetic prompts, timing every
tick. Prints the compression of the shipped weights, the throughput, a
TTFT / inter-token-latency line, and the first requests' tokens.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ArchConfig, build_model, get_config
from repro_torch.device import resolve_device
from repro_torch.kernels.tiled_xnor import COMPUTE_PATHS
from repro_torch.nn import module as mod
from repro_torch.nn.context import SERVE, TRAIN, ModelContext
from repro_torch.serve.engine import BatchedEngine, ServeConfig
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.weights import (
    export_serving_params,
    serving_bytes,
    spec_bytes,
)


def device_label(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device).upper()


def build_serving(cfg: ArchConfig, *, device, seed: int,
                  compute_dtype=torch.bfloat16, compute_path: str = "float"):
    """Random TRAIN masters from ``seed`` -> (SERVE model, SERVE params,
    master bytes). The SERVE model applies its dense layers through
    ``compute_path``. The masters are streamed: each master leaf is built
    (as ``t_model.init(seed)`` builds it), exported and freed before the
    next, so the peak is the largest leaf plus the shipped params, not the
    whole tree (qwen1.5-32b: one 36 GB stacked MLP leaf of 140 GB)."""
    t_model = build_model(cfg, ModelContext(
        policy=cfg.tbn, mode=TRAIN, compute_dtype=compute_dtype, device=device))
    s_model = build_model(cfg, ModelContext(
        policy=cfg.tbn, mode=SERVE, compute_dtype=compute_dtype, device=device,
        compute_path=compute_path))
    t_specs = t_model.specs()
    masters = mod.LazyParams(t_specs, seed, t_model.device)
    with torch.no_grad():
        sp = export_serving_params(t_specs, s_model.specs(), masters, cfg.tbn)
    if s_model.device.type == "cuda":
        torch.cuda.empty_cache()
    return s_model, sp, spec_bytes(t_specs)


def synthetic_prompts(rng: np.random.Generator, n: int, vocab: int,
                      lo: int = 3, hi: int = 12):
    """``n`` random prompts of lo <= length < hi tokens."""
    return [rng.integers(0, vocab, size=int(rng.integers(lo, hi))).astype(np.int32)
            for _ in range(n)]


def synthetic_clips(rng: np.random.Generator, n: int, d: int, lo: int, hi: int):
    """``n`` random source clips (frames, d), standard normal f32, of lo <=
    frames < hi."""
    return [rng.standard_normal((int(rng.integers(lo, hi)), d)).astype(np.float32)
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
    ap.add_argument("--enc-tokens", type=int, default=None,
                    help="encoder capacity in source frames (encdec "
                         "family only; default --max-len)")
    ap.add_argument("--enc-sources", type=int, default=2,
                    help="distinct synthetic source clips cycled over the "
                         "requests (encdec family)")
    ap.add_argument("--compute-path", default="float",
                    choices=COMPUTE_PATHS,
                    help="dense serve compute: float (byte-parity "
                         "reference), int8 (quantized activations, integer "
                         "MACs) or xnor (sign-binarized activations, "
                         "XNOR+popcount on the packed tile words); the "
                         "integer paths apply to decode ticks and outputs "
                         "are approximate vs float")
    ap.add_argument("--aot", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="capture the decode and extend ticks as CUDA "
                         "graphs before serving (BatchedEngine.warmup)")
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
    encdec = cfg.family == "encdec"
    if encdec and args.enc_sources < 1:
        raise SystemExit(f"--enc-sources must be >= 1: {args.enc_sources}")
    s_model, sp, master_b = build_serving(cfg, device=device, seed=args.seed,
                                          compute_path=args.compute_path)
    if args.compute_path != "float":
        print(f"compute path: {args.compute_path} (decode ticks quantize "
              f"activations and accumulate on the packed tile words; "
              f"outputs are approximate vs --compute-path float)")
    ship_b = serving_bytes(sp)
    print(f"arch={cfg.name} TBN p={cfg.tbn.p}: masters {master_b / 1e6:.2f}MB "
          f"-> shipped {ship_b / 1e6:.2f}MB ({master_b / ship_b:.1f}x smaller)")

    eng = BatchedEngine(s_model, sp, ServeConfig(
        n_slots=args.slots, max_len=args.max_len,
        chunk_tokens=min(args.chunk_tokens, args.max_len),
        temperature=args.temperature, top_k=args.top_k, seed=args.seed,
        page_tokens=args.page_tokens, compute_path=args.compute_path,
        enc_tokens=args.enc_tokens if encdec else None))
    if args.aot:
        t = eng.warmup()
        print(f"AOT warmup: {', '.join(f'{k} {v:.2f}s' for k, v in t.items())}")
    rng = np.random.default_rng(args.seed)
    prompts = synthetic_prompts(rng, args.requests, cfg.vocab)
    clips = (synthetic_clips(rng, args.enc_sources, cfg.d_model,
                             max(1, eng.enc_tokens // 2), eng.enc_tokens + 1)
             if encdec else None)
    reqs = [eng.submit(p, SamplingParams(max_tokens=args.max_tokens),
                       frames=clips[i % len(clips)] if encdec else None)
            for i, p in enumerate(prompts)]
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
    if encdec:
        st = eng.stats()
        pools = ", ".join(f"{name} {f['in_use']}/{f['pages']} pages"
                          for name, f in st["cache_families"].items())
        print(f"encode phase: {st['encode_ticks']} encode ticks of "
              f"{eng.enc_tokens} frames ({len(clips)} sources); {pools} "
              f"after the drain")
    for r in reqs[:3]:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.output}")
    return reqs


if __name__ == "__main__":
    main()
