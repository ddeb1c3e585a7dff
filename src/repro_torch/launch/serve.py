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

The engine's reuse and scheduling features: ``--prefix-cache`` (on by
default; ``--no-prefix-cache`` turns it off) shares prompt prefixes through
the radix trie, and for the encdec family reuses the encoder output of a
repeated source (``--enc-sources`` clips shared by the requests);
``--shared-prefix N`` prepends N common tokens to every prompt;
``--pool-pages`` sizes the K/V pool (LRU trie leaves are evicted under
pressure); ``--priorities`` orders admission by class (every 4th request is
interactive) and ``--preempt`` lets a waiting interactive request park a
batch slot and resume it later; ``--telemetry`` (on by default) keeps
request spans and tick phase histograms, and ``--trace-log FILE`` writes
the trace-event ring (``--trace-events`` events) to FILE as JSON lines.
``--ckpt-dir`` restores the TRAIN masters of a ``repro_torch.launch.train``
checkpoint before the export.

``--serve`` boots the asyncio HTTP/SSE front end (``serve/server.py``:
``POST /generate``, ``GET /stats``, ``GET /metrics``, ``GET /healthz``)
over the engine instead of draining a synthetic batch, and stops on SIGINT
or SIGTERM:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \\
        --serve --port 8000

It prints ``serving on http://HOST:PORT (aot=on|off)`` once it accepts
connections (``--port 0``: the port the OS picked). ``--aot`` is on by
default there (the ticks are captured before the socket is bound) and off
in the batch mode; ``--max-queued`` bounds the admission queue (a full one
answers HTTP 429); ``--stats-interval S`` prints a ``[stats]`` line every S
seconds. The encoder-decoder family is refused under ``--serve``: its
requests need source frames, which the HTTP body does not carry.

``--mesh DPxTP`` serves tensor- and expert-parallel over DP * TP ranks
(``distributed/sharding.py``: each tiled layer's tile rows split over the
"model" axis, a MoE bank's experts too, the batch over "data" where it
divides), started by ``torch.distributed.run``:

    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 2 -m repro_torch.launch.serve --arch granite-8b \
        --reduced --mesh 1x2

The backend follows ``launch/mesh.mesh_backend``: NCCL when each rank has a
card of its own, gloo when the ranks share one (or run on the CPU, with
``--device cpu``); the first rank prints it with the reason, the mesh's
tile bytes per rank, and the reports. The first rank takes the requests and
the others follow it (``BatchedEngine.follow``, ``serve/control.py``).
``--aot`` warms every rank up (the ticks captured as graphs split at their
collectives); ``--serve`` runs the HTTP shell on the first rank, which
alone prints the readiness line and its pid: a SIGINT or SIGTERM to that
process closes the server and stops the followers, and every rank exits
0 (the followers ignore both signals, so a signal to the whole job reaches
the first rank's handler and no follower dies in a collective).

Flow: build the TRAIN masters on the device one leaf at a time (or read
them from the checkpoint), export
each to the SERVE form (packed tile rows + alpha) and free it, stand up
the ``BatchedEngine`` and drain a batch of synthetic prompts, timing every
tick. Prints the compression of the shipped weights, the throughput, a
TTFT / inter-token-latency line, and the first requests' tokens.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import os
import time
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ArchConfig, build_model, get_config
from repro_torch.device import resolve_device
from repro_torch.ft.checkpoint import latest_step, restore_checkpoint
from repro_torch.kernels.tiled_xnor import COMPUTE_PATHS
from repro_torch.launch.mesh import init_mesh, parse_mesh_arg
from repro_torch.nn import module as mod
from repro_torch.nn.context import SERVE, TRAIN, ModelContext
from repro_torch.serve.engine import BatchedEngine, ServeConfig
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.weights import (
    export_serving_params,
    per_device_tile_bytes,
    serving_bytes,
    spec_bytes,
    tile_serving_bytes,
)


def device_label(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device).upper()


class CheckpointMasters:
    """A read-only view of the TRAIN masters stored in a checkpoint (the
    ``params`` of a train CLI's state, or a bare master tree), offering what
    ``export_serving_params`` reads of a param tree (``[key]``, ``get``):
    each leaf is moved to ``device`` when read and kept nowhere."""

    def __init__(self, flat: Dict[str, np.ndarray], specs: dict, device,
                 prefix: str = ""):
        self._flat, self._specs, self._device = flat, specs, device
        self._prefix = prefix

    def __getitem__(self, key: str):
        spec, path = self._specs[key], f"{self._prefix}{key}"
        if isinstance(spec, mod.ParamSpec):
            if path not in self._flat:
                raise KeyError(f"checkpoint has no master leaf {path}")
            arr = self._flat[path]
            if tuple(arr.shape) != tuple(spec.shape):
                raise ValueError(f"master {path}: stored shape {arr.shape} != "
                                 f"{tuple(spec.shape)}")
            return torch.from_numpy(arr).to(self._device, spec.dtype)
        return CheckpointMasters(self._flat, spec, self._device, f"{path}/")

    def get(self, key: str, default=None):
        return self[key] if key in self._specs else default


def checkpoint_masters(ckpt_dir, specs: dict, device):
    """(step, :class:`CheckpointMasters`) of the latest checkpoint under
    ``ckpt_dir``, or None when it holds none."""
    if latest_step(ckpt_dir) is None:
        return None
    step, flat, _ = restore_checkpoint(ckpt_dir)
    prefix = "params/" if any(k.startswith("params/") for k in flat) else ""
    return step, CheckpointMasters(flat, specs, torch.device(device), prefix)


def build_serving(cfg: ArchConfig, *, device, seed: int,
                  compute_dtype=torch.bfloat16, compute_path: str = "float",
                  ckpt_dir=None):
    """TRAIN masters -> (SERVE model, SERVE params, master bytes): random
    ones from ``seed``, or the latest checkpoint's under ``ckpt_dir``
    where it holds one. The SERVE model applies its dense layers through
    ``compute_path``. The masters are streamed: each master leaf is built
    (as ``t_model.init(seed)`` builds it) or read, exported and freed
    before the next, so the peak is the largest leaf plus the shipped
    params, not the whole tree (qwen1.5-32b: one 36 GB stacked MLP leaf of
    140 GB)."""
    t_model = build_model(cfg, ModelContext(
        policy=cfg.tbn, mode=TRAIN, compute_dtype=compute_dtype, device=device))
    s_model = build_model(cfg, ModelContext(
        policy=cfg.tbn, mode=SERVE, compute_dtype=compute_dtype, device=device,
        compute_path=compute_path))
    t_specs = t_model.specs()
    masters = mod.LazyParams(t_specs, seed, t_model.device)
    restored = (checkpoint_masters(ckpt_dir, t_specs, t_model.device)
                if ckpt_dir else None)
    if restored is not None:
        print(f"restored masters at step {restored[0]}")
        masters = restored[1]
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


def serve_http(eng: BatchedEngine, args, aot: bool) -> None:
    """Run the HTTP/SSE front end over ``eng`` until SIGINT or SIGTERM; the
    readiness line is printed (and flushed) once it accepts connections."""
    import asyncio

    from repro_torch.serve.server import ServerConfig, run_server

    def ready(_srv, port):
        print(f"serving on http://{args.host}:{port} "
              f"(aot={'on' if aot else 'off'})", flush=True)

    try:
        asyncio.run(run_server(eng, ServerConfig(host=args.host, port=args.port),
                               aot=aot, ready=ready,
                               stats_interval=args.stats_interval))
    except KeyboardInterrupt:
        pass


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
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="KV pool capacity in pages (default: the "
                         "dense-equivalent slots * max_len / page_tokens)")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="radix-trie shared-prefix reuse across admissions; "
                         "encoder-output reuse for the encdec family "
                         "(--no-prefix-cache disables)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend this many common tokens to every prompt "
                         "(a synthetic system prompt for the prefix cache)")
    ap.add_argument("--priorities", action="store_true",
                    help="class-aware admission (interactive > batch, "
                         "prefix-aware queue jumping, aging floor) instead "
                         "of FIFO; every 4th synthetic request is interactive")
    ap.add_argument("--preempt", action="store_true",
                    help="preempt-and-resume: a waiting interactive request "
                         "may park a batch slot (snapshot and retained "
                         "pages, restored byte-exactly); implies --priorities")
    ap.add_argument("--default-priority", default="batch",
                    help="class of requests that set none (interactive | batch)")
    ap.add_argument("--telemetry", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serving telemetry: metric registry, request spans, "
                         "tick phase timing, eager-tick detector "
                         "(--no-telemetry; tokens are the same either way)")
    ap.add_argument("--trace-log", default=None, metavar="FILE",
                    help="write the trace-event ring (submit / admit / "
                         "preempt / resume / finish / retrace) to FILE as "
                         "JSON lines after the drain")
    ap.add_argument("--trace-events", type=int, default=4096,
                    help="trace-event ring capacity (with --trace-log; the "
                         "oldest events drop past it)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore the TRAIN masters of the latest checkpoint "
                         "here (the train CLI's --ckpt-dir) before the export")
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
                    default=None,
                    help="capture the decode and extend ticks as CUDA "
                         "graphs before serving (BatchedEngine.warmup; "
                         "default: on with --serve, off otherwise)")
    ap.add_argument("--serve", action="store_true",
                    help="boot the async HTTP/SSE front end instead of "
                         "draining a synthetic batch")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000,
                    help="HTTP port (0 = OS-assigned, printed at startup)")
    ap.add_argument("--max-queued", type=int, default=64,
                    help="admission-queue capacity; a full queue returns "
                         "HTTP 429 (--serve mode)")
    ap.add_argument("--stats-interval", type=float, default=0.0,
                    help="print a one-line telemetry report every S "
                         "seconds (--serve mode; 0 disables)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--mesh", default="1x1",
                    help="DPxTP serving mesh, e.g. 1x2 (default single "
                         "device); run under python -m torch.distributed.run "
                         "--nproc-per-node DP*TP")
    args = ap.parse_args(argv)
    if args.stats_interval < 0:
        raise SystemExit(f"--stats-interval must be >= 0: {args.stats_interval}")
    if args.shared_prefix < 0:
        raise SystemExit(f"--shared-prefix must be >= 0: {args.shared_prefix}")
    if args.max_len < args.shared_prefix + 12:
        raise SystemExit(f"--max-len {args.max_len} is below the longest "
                         f"synthetic prompt ({args.shared_prefix} shared + 11 "
                         f"tokens)")
    if args.trace_log and not args.telemetry:
        raise SystemExit("--trace-log requires --telemetry (the ring is fed "
                         "from the telemetry call sites)")
    dims = parse_mesh_arg(args.mesh)
    if dims is None:
        return _serve_main(args, None, None)
    mesh, device, backend, why = init_mesh(*dims, args.device)
    first = dist.get_rank() == int(mesh.mesh.flatten()[0])
    try:
        # the first rank reports; the others run the same schedule quietly
        with (contextlib.nullcontext() if first
              else contextlib.redirect_stdout(io.StringIO())):
            print(f"mesh {args.mesh}: {dist.get_world_size()} ranks, "
                  f"backend={backend} ({why})", flush=True)
            return _serve_main(args, mesh, device)
    finally:
        dist.destroy_process_group()


def _serve_main(args, mesh, device):
    """The CLI's run on one device, or on this rank of ``mesh``."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    encdec = cfg.family == "encdec"
    if encdec and args.serve:
        raise SystemExit(
            "--serve (HTTP front-end) carries token prompts only; the "
            "encdec family needs per-request source frames — drive it "
            "with the synthetic batch (drop --serve)")
    device = device or resolve_device(args.device)
    if encdec and args.enc_sources < 1:
        raise SystemExit(f"--enc-sources must be >= 1: {args.enc_sources}")
    s_model, sp, master_b = build_serving(cfg, device=device, seed=args.seed,
                                          compute_path=args.compute_path,
                                          ckpt_dir=args.ckpt_dir)
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
        page_tokens=args.page_tokens, pool_pages=args.pool_pages,
        prefix_cache=args.prefix_cache, priorities=args.priorities or args.preempt,
        preempt=args.preempt, default_priority=args.default_priority,
        compute_path=args.compute_path,
        enc_tokens=args.enc_tokens if encdec else None,
        max_queued=args.max_queued if args.serve else None,
        telemetry=args.telemetry,
        trace_events=args.trace_events if args.trace_log else 0), mesh=mesh)
    aot = args.aot if args.aot is not None else args.serve
    if mesh is not None and aot:
        # collective: every rank captures its ticks at this point
        t = eng.warmup()
        if not args.serve:
            print(f"AOT warmup: {', '.join(f'{k} {v:.2f}s' for k, v in t.items())}")
    if mesh is not None:
        total = tile_serving_bytes(sp)
        per_rank = per_device_tile_bytes(eng.params, mesh)
        worst = max(per_rank.values())
        shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
        print(f"mesh={shape}: tile bits {total / 1e6:.3f}MB total, "
              f"{worst / 1e6:.3f}MB max/device ({total / max(worst, 1):.1f}x "
              f"sharding)")
        del sp      # the rank keeps only its blocks of the tiles
        if not eng.is_first:
            import signal

            # the first rank's handler stops the job; a follower only ends
            # on its stop flag
            for sig in (signal.SIGINT, signal.SIGTERM):
                signal.signal(sig, signal.SIG_IGN)
            eng.follow()
            return []

    def flush_trace_log():
        if args.trace_log and eng.tel is not None and eng.tel.ring is not None:
            n = eng.tel.ring.write_jsonl(args.trace_log)
            dropped = eng.tel.ring.dropped
            print(f"trace log: {n} events -> {args.trace_log}"
                  + (f" ({dropped} older events dropped by the "
                     f"{eng.cfg.trace_events}-event ring)" if dropped else ""))

    if args.serve:
        if mesh is not None:
            print(f"first rank {dist.get_rank()} (pid {os.getpid()}) serves, "
                  f"{dist.get_world_size() - 1} follow", flush=True)
        serve_http(eng, args, aot)
        flush_trace_log()
        print("server closed", flush=True)
        return []
    if aot and mesh is None:
        t = eng.warmup()
        print(f"AOT warmup: {', '.join(f'{k} {v:.2f}s' for k, v in t.items())}")
    rng = np.random.default_rng(args.seed)
    prompts = synthetic_prompts(rng, args.requests, cfg.vocab)
    clips = (synthetic_clips(rng, args.enc_sources, cfg.d_model,
                             max(1, eng.enc_tokens // 2), eng.enc_tokens + 1)
             if encdec else None)
    if args.shared_prefix:
        shared = rng.integers(0, cfg.vocab, size=args.shared_prefix)
        prompts = [np.concatenate([shared, p]).astype(np.int32) for p in prompts]
    reqs = [eng.submit(p, SamplingParams(
                max_tokens=args.max_tokens,
                # under --priorities every 4th request is interactive
                priority="interactive" if eng.cfg.priorities and i % 4 == 3
                else None),
                frames=clips[i % len(clips)] if encdec else None)
            for i, p in enumerate(prompts)]
    ticks, dt, tick_ends = drain(eng, reqs)
    eng.stop_followers()
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
    st = eng.stats()
    if encdec:
        pools = ", ".join(f"{name} {f['in_use']}/{f['pages']} pages"
                          for name, f in st["cache_families"].items())
        print(f"encode phase: {st['encode_ticks']} encode ticks of "
              f"{eng.enc_tokens} frames ({len(clips)} sources), "
              f"{st['enc_cache_hits']}/{st['admitted']} admissions reused a "
              f"cached encoder output; {pools} after the drain")
    elif eng.cfg.prefix_cache:
        line = (f"hit rate {100 * st['hit_rate']:.0f}% ({st['prefix_hits']}/"
                f"{st['admitted']} admissions), {st['prefix_tokens']}/"
                f"{st['prompt_tokens']} prefill tokens skipped, "
                f"{st['trie_nodes']} trie nodes")
        if eng.pool is not None:
            line += (f", pool {st['pages_in_use']}/{st['pool_pages']} pages "
                     f"({100 * st['page_utilization']:.0f}%)")
        print(f"prefix cache (page={eng.cfg.page_tokens}): {line}")
    else:
        print("prefix cache: disabled")
    if eng.cfg.priorities:
        per_cls = ", ".join(f"{cls} {t} ticks (n={st['class_counts'][cls]})"
                            for cls, t in st["class_ttft_ticks"].items())
        print(f"scheduler ({'priority+preempt' if eng.cfg.preempt else 'priority'}"
              f"): {st['preempts']} preempts / {st['resumes']} resumes, "
              f"{st['preempted_tokens']} context tokens parked, preempt-free "
              f"tick rate {st['preempt_free_tick_rate']:.2f}; TTFT "
              f"{per_cls or 'n/a'}")
    if "latency" in st:
        print("telemetry: " + " ".join(
            f"{k} p50={v['p50']}ms p99={v['p99']}ms"
            for k, v in st["latency"].items()
            if v["count"] and k in ("ttft_ms", "itl_ms", "tick_ms"))
            + f" | eager ticks after warmup={st['retraces']}")
    flush_trace_log()
    for r in reqs[:3]:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.output}")
    return reqs


if __name__ == "__main__":
    main()
