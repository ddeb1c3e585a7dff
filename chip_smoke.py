#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py          # from the root of a checkout

Phases (any failure raises and exits non-zero; no phase is skipped):
  1. print the card's name and power limit, build kernels B1-B6 from
     ``src/repro_torch/csrc`` (one nvcc per source, in parallel), print
     ptxas's registers and spills, and require the tensor-core instruction
     of each tensor-core body in its library's SASS (``cuobjdump
     --dump-sass``): HGMMA (wgmma) in B2's and B6's, HMMA (mma.sync bf16)
     in B1's, IMMA (mma.sync s8) in B4's, BMMA (mma.sync b1 AND-popc) in
     B3's;
  2. kernel vs plain version on the card at the (K, r) pairs of the
     full-width granite-8b path. B1 at m in {1, 4, 8, 16, 32} and B2 at m
     in {33, 128, 512}, bf16 and f32, and B2 in bf16 at m = 2048 (the
     fused train step's B*S; its per-step total is printed), each
     compared at rtol=1e-4, atol=1e-4*max|u_ref| (x*±1 is exact in f32,
     so only the summation
     order differs). B3 (xnor) and B4 (int8) at m in {1, 4, 8, 16, 32} on
     quantized random activations, plus an n_in = 80 case whose tile comes
     from ``pack_bits`` (pad bits): their int32 accumulators must be
     exactly equal. Each is timed beside the plain version, the library
     yardstick (``torch.matmul`` in bf16 on pre-unpacked operands, which
     the port never calls) and the data-sheet bound, with its TFLOP/s. In
     bf16 every body of B1 and B2, and every body of B3 (each tensor-core
     body with K whole and with K split and added in a cluster) and of B4,
     is held to the same check (B3 / B4: equal, B3 also at n_in =
     80), run twice and equal, and timed beside its modelled time (the
     planner's cost model) and the planner's pick; B2's
     totals per fused train step and per extend tick are printed, and the
     totals of B1, B3 and B4 per decode tick at m = 4 and m = 32, each
     with the min-max of its timing reps, and the planners' host time per
     decode tick, cached and not. B5 (tile
     construction) at the five full-width (p, q) shapes of granite-8b's
     tiled layers, f32 masters, alpha from W and from a separate A, plus a
     q = 500 case through ``ops.tile_construct`` (padding): packed words
     ``torch.equal`` to the plain version, alpha at rtol 1e-5, timed beside
     the plain version and the bound (no single PyTorch call computes B5);
  2b. the planners' picks of B1-B4 (no body survey) at every (K, r) of
     qwen1.5-32b, starcoder2-7b, minitron-8b, mamba2-370m and
     recurrentgemma-2b that granite-8b has not (r = 1096 and 12570 are no
     multiple of 16, r = 32 is one filter tile): B1 at m in {1, 4, 32} and
     B2 at m = 128, bf16 and f32, at the same tolerance; B3 / B4 at m in
     {1, 4, 32}, equal; each timed beside the plain version, the library
     yardstick and the bound, with the pick; then the totals of
     qwen1.5-32b (L = 64), mamba2-370m (L = 48) and recurrentgemma-2b (L
     = 26) per extend tick and per decode tick at m = 4 and m = 32;
  3. serve granite-8b at its published width through the user entry points
     (masters from a seed -> export -> BatchedEngine): 8 requests, prompts
     of 3-100 tokens, 16 greedy tokens each, 4 slots, 32-token chunks,
     16-token pages, first with ``compute_path`` "float", then "xnor", then
     "int8" on the same exported weights. Every launch counter is set to 0
     just before each run and read just after it; each run asserts that its
     decode kernel took every m <= 32 projection and that the kernels of the
     other paths were not launched. Each (config, path) is then served warm:
     a new engine, ``warmup()`` (the decode and extend ticks captured as
     CUDA graphs; its warm-up runs and capture must launch exactly
     WARM_RUNS + 1 ticks' worth of the path's kernels), the same requests;
     the warm drain must launch nothing through the wrappers, leave the
     engine's ``TRACE_COUNTS`` unchanged and emit the cold run's greedy
     tokens at the same ticks, byte for byte; capture seconds, the graph
     pool's device bytes and cold -> warm tick ms, tok/s, TTFT and ITL are
     printed. Then three decode-only ticks of each path are traced with
     torch.profiler, cold and warm (device busy time vs the tick's wall
     time, the decode kernel's share, top kernels; in a replay the decode
     kernel must be among the device events), and one decode-only tick of
     32 slots (every projection at m = 32) under each path, cold and warm;
  4. the same exported weights at full width, 2 layers, f32: one extend and
     one decode_step on the card (kernels) against the CPU model (plain
     versions), float logits at rtol=atol=1e-3 (attention softmax and norms
     also reorder sums). The integer paths are held at the layer level:
     ``tiled_dense_infer`` at every full-width shape, m = 4, card against
     CPU, with equal quantized operands and int32 accumulators and outputs
     at rtol=1e-5 (the f32 scale mean|x| is a reordered sum). Over a whole
     model a reordered f32 sum upstream can flip one activation's sign or
     int8 rounding, so the integer paths' model-level max|d logit| is
     printed and only checked to be finite;
  4b. serve qwen1.5-32b at its published width and QWEN_SERVE_LAYERS = 16
     of its 64 layers (cut when the SSM and hybrid phases made the run
     longer), with its int8 KV cache, from masters built, exported and freed one leaf at a
     time (``build_serving``; the peak of device memory across the build
     is printed and must leave 10% of the card): the requests of phase 3
     under "float", "xnor" and "int8" on one export, cold and warm, with
     the same counter and token checks (own kernel = (7 L + 1) per decode
     tick + 1 per extend tick), the K/V pools int8 codes with f32 scales,
     and one 4-slot decode tick traced per path, cold and warm; each
     engine and its graphs are freed before the next;
  4c. qwen1.5-32b at full width, 2 layers, f32: ``quantize_kv`` card
     against CPU on one K tensor (codes and scales equal); one extend and
     one decode step on the card against the CPU model, with float K/V
     pools (logits at rtol=atol=1e-3) and with the int8 KV cache (codes
     within one step, the count that differ printed; layer 0's scales at
     rtol 1e-5;
     decode logits from the card's pools at rtol=atol=1e-3; the logits
     from each device's own codes printed, finite);
  4d. minitron-8b and starcoder2-7b at their published width, cut to
     FAMILY_SERVE_LAYERS = 8 of their 32 layers, built the same way, float
     path: 4 requests of 8 greedy tokens each, cold and warm, with the
     same counter and token checks (own kernel = (6 L + 1) per decode tick
     + 1 per extend tick: their MLPs are not gated), first tokens printed;
  4e. serve qwen2-moe-a2.7b at its published width and all 24 layers
     (60 routed experts top-4 plus 4 shared a layer), bf16, from masters
     built, exported and freed one leaf at a time (the largest leaf is an
     (L, E, 1408, 2048) f32 expert bank of 16.6 GB; the build's peak of
     device memory is printed and must leave 10% of the card): the
     requests of phase 3 under "float", "xnor" and "int8" on one export,
     cold and warm, with the same counter and token checks (own kernel =
     (7 L + 1) per decode tick + 1 per extend tick: q, k, v, o and the
     shared experts' gate, up, down; the routed experts run as plain
     batched products on banks rebuilt from their tiles and launch no
     kernel), and one 4-slot decode tick traced per path, cold and warm,
     with the routed experts' share of it: their rebuild and their
     products timed alone at the tick's shape, and under their kernel
     names in the trace;
  4f. serve moonshot-v1-16b-a3b at its published width and all 48 layers
     (a dense first layer, then 64 routed experts top-6 plus 2 shared),
     int8 K/V cache, built the same way (largest leaf 34.7 GB): float path,
     4 requests of 8 greedy tokens, cold and warm, the same checks, first
     tokens printed, one decode tick traced cold and warm;
  4g. qwen2-moe-a2.7b at full width, 2 layers, f32: one extend and one
     decode step on the card against the CPU model; every MoE call's
     top-k expert ids and dispatch positions must be equal (a difference
     fails and names the token and the gap between its k-th and (k+1)-th
     router probability), logits at rtol = atol = 1e-3;
  4h. serve mamba2-370m at its published width and all 48 layers (SSD
     state 128, no attention, no FFN), bf16, built the same way: the
     requests of phase 3 under "float", "xnor" and "int8" on one export,
     cold and warm, with the same counter and token checks (own kernel =
     (2 L + 1) per decode tick + 1 per extend tick: in_proj and out_proj),
     no page pool, f32 (h, conv) carries; the warmup captures the slot
     reset too (``reset_slot``), and the warm drain must run no eager
     reset; one 4-slot decode tick traced per path, cold and warm;
  4i. serve recurrentgemma-2b at its published width and all 26 layers (8
     cycles of rec, rec, attn, then two rec tails; MQA kv 1, head dim 256,
     a 2048-token window ring), the same runs as 4h (own kernel = (8 rec +
     7 attn per layer) + 1 per decode tick); then one request of a
     2100-token prompt, longer than the window, on a 2304-token slot under
     "float", cold and warm (the ring wraps at full width; warm tokens
     equal cold);
  4j. card against CPU, f32, full width: mamba2-370m at 2 layers and
     recurrentgemma-2b at 5 (one cycle and both tails) on the shipped
     weights of 4h / 4i: two slots extend ragged prompts in 512-token
     chunks (recurrentgemma: 2100 and 300 tokens, so the ring wraps), then
     three greedy decode steps; logits at rtol = atol = 1e-4 at every call
     and the greedy tokens equal;
  5. train granite-8b at published width, 4 layers (n_layers 36 -> 4: the
     masters, gradients and AdamW moments of all 36 do not fit one card),
     through ``launch.train.build_training`` as the CLI wires it but with
     ``ModelContext(fused_train=True)``: f32 masters from seed 0, bf16
     compute, batch 4 x 512, AdamW(cosine(3e-4, 2, 8), wd 0.1), clip 1.0,
     checkpoints every 3 steps in a temp dir. Six steps; then the step-6
     checkpoint is dropped and a second RecoveryManager resumes from step 3
     to 6. Losses and grad norms finite, no restart in either run, replayed
     losses within rtol 1e-3 of the first run's (the embedding backward's
     atomics reorder f32 sums), and the launch counters: B5 = B2 = steps *
     (14 L + 1), B1 = B3 = B4 = 0. Then the steady step time and a
     torch.profiler trace of one step;
  6. the training CLI on the card (unfused default path): ``python -m
     repro_torch.launch.train --arch granite-8b --reduced --steps 3`` and
     the same with ``--arch qwen2-moe-a2.7b`` (the MoE TRAIN dispatch) must
     each exit 0 with "done: 3 steps";
  7. full width, 2 layers, f32, batch 1 x 64: fused ``train_forward`` and
     backward on the card (kernels) against the CPU (plain versions) on the
     same masters: the B5 words of every layer equal, the loss within rtol
     1e-4, every gradient leaf within rtol 1e-3, atol 1e-3 * max|g|;
  8. B6 (fused-im2col tiled conv) against its plain version on the card at
     the four tiled-conv shapes of ResNet-34 ImageNet (28x28x128 -> 14x14
     s2 r 128; 14x14x256 s1 r 128; 14x14x256 -> 7x7 s2 r 256; 7x7x512 s1
     r 256), N in {1, 64}, bf16 and f32, rtol 1e-4, atol 1e-4*max|u_ref|;
     timed beside the plain version, the library yardstick (``F.conv2d``
     in the input's type on the unpacked ±1 bank, cuDNN, which the port
     never calls) and the bound, per shape and summed per forward (18
     calls), with TFLOP/s; in bf16 every body is checked and timed as in
     phase 2. Then ``ops.tiled_conv_infer`` card against CPU for C = 48, a
     1x1 stride-2 256 -> 512 conv at p = 8, kernel (5, 3) stride (1, 2)
     VALID, SAME_LOWER, explicit pads [(2, 1), (0, 2)], alpha "layer" and
     "tile";
  9. serve the paper's ResNet-34 ImageNet (Table 1: TBN p = 2, lambda 150k,
     alpha per tile from A, 1000 classes) at full width through the entry
     points of a user: TRAIN masters from seed 0 -> ``export_serving_params``
     -> SERVE model (bf16) forward. The ledger must read 21,779,648 params,
     11.646 Mbit, 0.5347 bits/param. 64 images of 224 x 224 x 3: one
     warm-up, then 10 timed forwards (median ms and images/s), and 10
     forwards at N = 1 (latency); counters zeroed before and read after
     each run: B6 = 18 per forward, B2 = 1 per N = 64 forward, B1 = 1 per
     N = 1 forward, B3 = B4 = B5 = 0. One N = 64 forward traced with
     torch.profiler (device busy vs wall, top kernels);
 10. the same export at full width in f32, N = 2 at 224 x 224: logits on
     the card (B6, B1, cuDNN for the BWNN convs) against the CPU model
     (plain versions) at rtol = atol = 1e-3.

The line before the last is a JSON object with one entry per kernel; the
last line is the JSON status line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# (name, K, r) of every tiled matmul of a full-width granite-8b layer, and
# how many times one layer calls it; the LM head runs once per tick.
SHAPES = (("q/o", 4096, 512, 2), ("k/v", 4096, 128, 2),
          ("gate/up", 4096, 1792, 2), ("down", 14336, 512, 1),
          ("lm_head", 4096, 6144, 0))
# (name, K, r, calls per layer) of the tiled matmuls of the other dense
# configs at full width (r = n_out / 8); granite-8b's (K, r) among them
# are checked by phase 2 and not again
FAMILY_SHAPES = {
    "qwen1.5-32b": (("q/k/v/o", 5120, 640, 4), ("gate/up", 5120, 3424, 2),
                    ("down", 27392, 640, 1), ("lm_head", 5120, 19008, 0)),
    "starcoder2-7b": (("q/o", 4608, 576, 2), ("k/v", 4608, 64, 2),
                      ("up", 4608, 2304, 1), ("down", 18432, 576, 1),
                      ("lm_head", 4608, 6144, 0)),
    "minitron-8b": (("q/o", 4096, 512, 2), ("k/v", 4096, 128, 2),
                    ("up", 4096, 2048, 1), ("down", 16384, 512, 1),
                    ("lm_head", 4096, 32000, 0)),
    # p = 4: r = n_out / 4
    "mamba2-370m": (("in_proj", 1024, 1096, 1), ("out_proj", 2048, 256, 1),
                    ("lm_head", 1024, 12570, 0)),
    # calls per tick of the whole 26-layer stack (18 rec layers: in_x,
    # in_gate, out, w_a, w_i; 8 attn layers: q, k, v, o; all: gate, up,
    # down), so its FAMILY_TICK_LAYERS is 1
    "recurrentgemma-2b": (("rec/q/o", 2560, 320, 18 * 5 + 8 * 2),
                          ("k/v", 2560, 32, 8 * 2), ("gate/up", 2560, 960, 26 * 2),
                          ("down", 7680, 320, 26), ("lm_head", 2560, 32000, 0)),
}
MAMBA, RECGEMMA = "mamba2-370m", "recurrentgemma-2b"
# the layers that FAMILY_SHAPES' per-layer counts multiply in a tick
FAMILY_TICK_LAYERS = {"qwen1.5-32b": 64, MAMBA: 48, RECGEMMA: 1}
# phase 4i's window-wrapping request: a prompt longer than the 2048 window
# on a slot of WRAP_MAX_LEN tokens; phase 4j's card-vs-CPU cut and chunk
WRAP_PROMPT, WRAP_MAX_LEN = 2100, 2304
SSM_CHECK_LAYERS = {MAMBA: 2, RECGEMMA: 5}
SSM_CHECK_CHUNK = 512
FAMILY_MS = (1, 4, 32)
QWEN = "qwen1.5-32b"
MOE, MOONSHOT = "qwen2-moe-a2.7b", "moonshot-v1-16b-a3b"
# tiled projections of one layer of the MoE configs (models/lm.py Block,
# nn/moe.py MoE): q, k, v, o and the shared experts' MLP gate, up, down; in
# moonshot's dense0 layer q, k, v, o and its MLP's gate, up, down. The
# routed experts launch no kernel: their banks are rebuilt from the tiles
# and run as plain batched products (torch.bmm), as the reference runs them
# (jnp.einsum, no Pallas kernel)
MOE_DENSE_CALLS = {MOE: 4 + 3, MOONSHOT: 4 + 3}
MOE_CHECK_LAYERS = 2
# phase 4d serves minitron-8b and starcoder2-7b at full width cut to 8 of
# their 32 identical layers: the MoE phases 4e-4g made the run longer, and
# the depth of the earliest-cut path goes first
FAMILY_SERVE_LAYERS = 8
# phase 4b serves qwen1.5-32b at full width cut to 16 of its 64 identical
# layers: phases 4h-4j made the run longer, and this depth is the next cut
QWEN_SERVE_LAYERS = 16
B1_MS = (1, 4, 8, 16, 32)
B2_MS = (33, 128, 512)
INT_MS = (1, 4, 8, 16, 32)
N_SLOTS, CHUNK = 4, 32
WIDE_SLOTS = MATVEC_M = 32   # MATVEC_MAX_M: the widest decode tick
RTOL = 1e-4
INT_RTOL = 1e-5
# Data-sheet peaks (dense): memory bytes/s, bf16 tensor-core flop/s, f32
# (non-tensor) flop/s, int8 tensor-core op/s; picked by the name nvidia-smi
# reports.
PEAKS = {"SXM": (3.35e12, 989e12, 67e12, 1979e12),
         "PCIe": (2.0e12, 756e12, 51e12, 1513e12),
         "NVL": (3.9e12, 835e12, 60e12, 1671e12)}
# compute path -> the kernel that runs its m <= 32 projections
PATH_KERNEL = {"float": "B1", "xnor": "B3", "int8": "B4"}
# (name, p, q, tiled Dense of that shape per layer) of every B5 call of a
# full-width granite-8b layer (p = 8, q = n_out * n_in / 8); the LM head
# is one more call per forward pass
B5_SHAPES = (("q/o", 8, 4096 * 4096 // 8, 2), ("k/v", 8, 1024 * 4096 // 8, 2),
             ("gate/up/down", 8, 14336 * 4096 // 8, 3),
             ("head", 8, 49152 * 4096 // 8, 0))
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = 4, 4, 512
TRAIN_STEPS, RESUME_FROM, REPLAY_RTOL = 6, 3, 1e-3
# (name, input H = W, C, r, stride, calls per forward) of every B6 call of
# ResNet-34 ImageNet at p = 2 (3x3 convs of stages 2 and 3; the rest stay
# BWNN under lambda = 150k)
CONV_SHAPES = (("s2.entry 28x28x128 s2", 28, 128, 128, 2, 1),
               ("s2 14x14x256 s1", 14, 256, 128, 1, 11),
               ("s3.entry 14x14x256 s2", 14, 256, 256, 2, 1),
               ("s3 7x7x512 s1", 7, 512, 256, 1, 5))
CONV_NS = (1, 64)
R34_BATCH, R34_TIMED = 64, 10
R34_LEDGER = (21_779_648, 11.646, 0.5347)   # params, Mbit, bits/param


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


def kernels():
    """{"B1".."B6": wrapper}: the wrappers whose ``launches`` count."""
    from repro_torch.kernels.tile_construct import tile_construct_kernel
    from repro_torch.kernels.tiled_conv import tiled_conv_unique
    from repro_torch.kernels.tiled_matmul import tiled_matmul_unique
    from repro_torch.kernels.tiled_matvec import tiled_matvec_unique
    from repro_torch.kernels.tiled_xnor import (
        tiled_int8_matvec_unique,
        tiled_xnor_matvec_unique,
    )

    return {"B1": tiled_matvec_unique, "B2": tiled_matmul_unique,
            "B3": tiled_xnor_matvec_unique, "B4": tiled_int8_matvec_unique,
            "B5": tile_construct_kernel, "B6": tiled_conv_unique}


def zero_counters():
    for fn in kernels().values():
        fn.launches = 0


def read_counters():
    return {name: fn.launches for name, fn in kernels().items()}


# library -> the tensor-core instruction its bodies must issue: wgmma (B2,
# B6), mma.sync bf16 (B1), mma.sync s8 (B4) and mma.sync b1 AND-popc (B3)
TENSOR_SASS = (("tiled_matmul", "HGMMA"), ("tiled_conv", "HGMMA"),
               ("tiled_matvec", "HMMA"), ("tiled_int8", "IMMA"),
               ("tiled_xnor", "BMMA"))


def check_tensor_core_sass(build) -> None:
    """The tensor-core bodies of B1-B4 and B6 must reach the tensor cores:
    each library's SASS must hold its instruction (TENSOR_SASS)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name, op in TENSOR_SASS:
        sass = subprocess.run([tool, "--dump-sass", str(build.lib_path(name))],
                              check=True, capture_output=True, text=True,
                              timeout=300).stdout
        n = sum(1 for line in sass.splitlines() if op in line)
        if n == 0:
            fail(f"{name}: no {op} instruction in the SASS of "
                 f"{build.lib_path(name).name}")
        print(f"  {name}: {n} {op} instructions in the SASS", flush=True)


def time_reps(fn, iters: int = 20, reps: int = 9):
    """Device time of one ``fn()`` call: ``iters`` calls captured in a CUDA
    graph, replayed ``reps`` times, each replay between CUDA events (launch
    overhead on the host is not in the number). Returns (median, min, max)
    over the replays, in ms a call: the median, because one slow replay (a
    stall of the card or its host) moved the mean of a few replays by up to
    2x at the smallest shapes."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    events[0].record()
    for i in range(reps):
        graph.replay()
        events[i + 1].record()
    torch.cuda.synchronize()
    per = [events[i].elapsed_time(events[i + 1]) / iters for i in range(reps)]
    return statistics.median(per), min(per), max(per)


def time_ms(fn, iters: int = 20, reps: int = 9) -> float:
    """The median of :func:`time_reps`."""
    return time_reps(fn, iters, reps)[0]


def timed(res, key: str, fn) -> None:
    """res[key] = median ms of fn, res[key + "_lo" / "_hi"] = min / max."""
    res[key], res[key + "_lo"], res[key + "_hi"] = time_reps(fn)


def check_kernel(kernel, plain, x, packed, bw, peak, survey: bool = True):
    """Run ``kernel`` once against ``plain`` on the same card inputs, assert
    the tolerance and that the launch counter rose, then time both and the
    library yardstick; in bf16, with ``survey``, hold and time every body
    (else note the planner's pick). Returns a dict of the measurements."""
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
    res = dict(err=err, scale=scale, flops=flops, bound_ms=max(t_bytes, t_ops),
               bytes_ms=t_bytes, ops_ms=t_ops)
    timed(res, "ms", lambda: kernel(x, packed))
    res["plain_ms"] = time_ms(lambda: plain(x, packed))
    timed(res, "library_ms", lambda: torch.matmul(x, dense.T))
    if not survey:
        res["body"] = picked(kernel.__name__, m, r, packed.shape[1],
                             x.dtype == torch.bfloat16)
        return res
    if kernel.__name__ == "tiled_matvec_unique" and x.dtype == torch.bfloat16:
        from repro_torch.kernels.tiled_matmul import _sm_count
        from repro_torch.kernels.tiled_matvec import (
            B1_COST,
            MV_BODIES,
            matvec_cost,
            plan_matvec,
            tiled_matvec_body,
        )

        sms, words = _sm_count(x.device.index), packed.shape[1]
        res.update(survey_bodies(
            lambda body: tiled_matvec_body(x, packed, body), want, MV_BODIES,
            lambda body: plan_matvec(m, r, words, sms, body=body),
            lambda plan: matvec_cost(plan, B1_COST, m, r, words, sms),
            f"B1 m={m} K={k} r={r}"))
    if kernel.__name__ == "tiled_matmul_unique" and x.dtype == torch.bfloat16:
        from repro_torch.kernels.tiled_matmul import (
            BODIES,
            _sm_count,
            plan_cost,
            plan_matmul,
            tiled_matmul_body,
        )

        sms = _sm_count(x.device.index)
        res.update(survey_bodies(
            lambda body: tiled_matmul_body(x, packed, body), want, BODIES,
            lambda body: plan_matmul(m, r, packed.shape[1], sms, body=body),
            lambda plan: plan_cost(plan, m, r, sms),
            f"B2 m={m} K={k} r={r}"))
    return res


def picked(kernel: str, m: int, r: int, words: int, bf16: bool = True) -> str:
    """The planner's pick for one call of ``kernel`` (a wrapper's name) on
    this card: the body and its K splits (B3: and how they are added)."""
    from repro_torch.kernels.tiled_matmul import _sm_count, plan_matmul
    from repro_torch.kernels.tiled_matvec import plan_matvec
    from repro_torch.kernels.tiled_xnor import plan_int8, plan_xnor

    sms = _sm_count(0)
    if kernel == "tiled_xnor_matvec_unique":
        plan = plan_xnor(m, r, words, sms)
        return f"{xnor_name(plan)} x{plan.splits}"
    plan = {"tiled_matvec_unique": lambda: plan_matvec(m, r, words, sms, bf16),
            "tiled_matmul_unique": lambda: plan_matmul(m, r, words, sms, bf16),
            "tiled_int8_matvec_unique": lambda: plan_int8(m, r, words, sms)}[kernel]()
    return f"{plan.body} x{plan.splits}"


def survey_bodies(run, want, bodies, plan_of, cost_of, what: str,
                  exact: bool = False, with_times: bool = True):
    """Every body of B1 / B2 / B6 (bf16) or B3 / B4 (``exact``) at one
    shape: held to the kernel's tolerance (B3 / B4: equal) against the same
    plain result, run twice and equal, and, if ``with_times``, timed beside
    its planned time (the planner's cost model). Returns the planner's pick
    and {body: (ms, modelled ms, splits)}."""
    import torch

    scale = float(want.abs().max())
    survey = {}
    for body in bodies:
        got = run(body)
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max())
        ok = (torch.equal(got, want) if exact else
              torch.allclose(got, want, rtol=RTOL, atol=RTOL * scale))
        if not ok:
            fail(f"{what} body {body}: max|err| {err:.3e} over tolerance "
                 f"(max|u| {scale:.3e}{', must be equal' if exact else ''})")
        if not torch.equal(run(body), got):
            fail(f"{what} body {body}: a second run differs from the first")
        if not with_times:
            continue
        plan = plan_of(body)
        survey[body] = (time_ms(lambda: run(body)), cost_of(plan) / 1e3,
                        plan.splits)
    return dict(body=plan_of(None).body, survey=survey)


def tflops(res) -> str:
    """Achieved TFLOP/s of a measurement; in bf16 the planner's body and
    every body's time (modelled time, K splits)."""
    return f"{res['flops'] / res['ms'] / 1e9:.0f} TFLOP/s" + bodies_line(res)


def bodies_line(res) -> str:
    """The planner's body and every surveyed body's time (modelled time, K
    splits), or "" when the bodies were not surveyed."""
    if "body" not in res:
        return ""
    if not res.get("survey"):
        return f" [{res['body']}]"
    return f" [{res['body']}] bodies: " + ", ".join(
        f"{b} {ms:.4f}ms (model {model:.4f}, {splits} splits)"
        for b, (ms, model, splits) in res["survey"].items())


def int_operands(path: str, m: int, n_in: int, r: int, gen):
    """(quantized activations as the kernel takes them, tile words, ±1 bf16
    activations for the library yardstick) from random card tensors; the
    tile is ``pack_bits`` of a random sign matrix, so pad bits are 0."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.packing import pack_bits, unpack_bits
    from repro_torch.kernels.tiled_xnor import quantize_int8, quantize_sign

    x = torch.randn((m, n_in), generator=gen, device="cuda").to(torch.bfloat16)
    packed = pack_bits(torch.randn((r, n_in), generator=gen, device="cuda"))
    k = packed.shape[1] * 32
    if path == "xnor":
        a, _ = quantize_sign(x, n_in)
        lib_x = F.pad(unpack_bits(a, n_in, dtype=torch.bfloat16), (0, k - n_in))
    else:
        q, _ = quantize_int8(x, n_in)
        a = F.pad(q, (0, k - n_in))
        lib_x = a.to(torch.bfloat16)
    return a, packed, lib_x


def xnor_variant(name):
    """(body, split reduction) of a surveyed B3 name ("bmma32/cluster");
    (None, None) for the planner's own pick."""
    body, _, reduce = (name or "").partition("/")
    return body or None, reduce or None


def xnor_name(plan) -> str:
    """The surveyed name of a B3 plan: the body, and for a tensor-core body
    how its K splits are added ("none" or "cluster")."""
    return plan.body if plan.code == 0 else f"{plan.body}/{plan.reduce}"


def check_int_kernel(path: str, m: int, n_in: int, r: int, gen, bw, int_peak,
                     with_times: bool = True, survey: bool = True):
    """B3 (``path`` "xnor") or B4 ("int8") once against its plain version on
    the same card inputs: the int32 accumulators must be equal. With
    ``survey``, for B3 also hold every body (and split reduction) to the
    plain version, run twice. Then, if ``with_times``, time the kernel, the
    plain version and the library yardstick, and, with ``survey``, every
    body of B3 and B4 beside the cost model."""
    import torch

    from repro_torch.kernels.tiled_matmul import unpack_rows
    from repro_torch.kernels.tiled_xnor import (
        int8_matvec_packed,
        xnor_matvec_words,
    )

    a, packed, lib_x = int_operands(path, m, n_in, r, gen)
    if path == "xnor":
        kernel = kernels()["B3"]
        run = lambda: kernel(a, packed, n_in=n_in)
        plain = lambda: xnor_matvec_words(a, packed, n_in=n_in)
    else:
        kernel = kernels()["B4"]
        run = lambda: kernel(a, packed)
        plain = lambda: int8_matvec_packed(a, packed, n_in=a.shape[1])
    before = kernel.launches
    got = run()
    torch.cuda.synchronize()
    if kernel.launches != before + 1:
        fail(f"{kernel.__name__} did not count its launch")
    want = plain()
    err = float((got.long() - want.long()).abs().max())
    if got.dtype != torch.int32 or not torch.equal(got, want):
        fail(f"{kernel.__name__} m={m} n_in={n_in} r={r}: int32 accumulator "
             f"differs from the plain version (max|err| {err})")
    res = dict(err=err, scale=float(want.abs().max()))
    words = packed.shape[1]
    if not survey:
        res["body"] = picked(kernel.__name__, m, r, words)
    elif path == "xnor":
        from repro_torch.kernels.tiled_matmul import _sm_count
        from repro_torch.kernels.tiled_matvec import matvec_cost
        from repro_torch.kernels.tiled_xnor import (
            B3_COST,
            XNOR_BODIES,
            plan_xnor,
            tiled_xnor_body,
            xnor_plans,
        )

        sms = _sm_count(a.device.index)
        names = [xnor_name(p) for b in XNOR_BODIES for p in xnor_plans(m, r, words, sms, b)]

        def forced(name):
            body, reduce = xnor_variant(name)
            return tiled_xnor_body(a, packed, body, n_in=n_in, reduce=reduce)

        res.update(survey_bodies(
            forced, want, names,
            lambda name: plan_xnor(m, r, words, sms, *xnor_variant(name)),
            lambda plan: matvec_cost(plan, B3_COST, m, r, words, sms),
            f"B3 m={m} K={n_in} r={r}", exact=True, with_times=with_times))
        res["body"] = xnor_name(plan_xnor(m, r, words, sms))
    if not with_times:
        return res
    nbytes = a.numel() * a.element_size() + packed.numel() * 4 + m * r * 4
    ops = 2.0 * m * r * (words if path == "xnor" else n_in)
    t_bytes, t_ops = 1e3 * nbytes / bw, 1e3 * ops / int_peak
    dense = unpack_rows(packed).to(torch.bfloat16)
    res.update(bound_ms=max(t_bytes, t_ops), bytes_ms=t_bytes, ops_ms=t_ops)
    timed(res, "ms", run)
    res["plain_ms"] = time_ms(plain)
    timed(res, "library_ms", lambda: torch.matmul(lib_x, dense.T))
    if path == "int8" and survey:
        from repro_torch.kernels.tiled_matmul import _sm_count
        from repro_torch.kernels.tiled_matvec import matvec_cost
        from repro_torch.kernels.tiled_xnor import (
            B4_COST,
            INT8_BODIES,
            plan_int8,
            tiled_int8_body,
        )

        sms = _sm_count(a.device.index)
        res.update(survey_bodies(
            lambda body: tiled_int8_body(a, packed, body), want, INT8_BODIES,
            lambda body: plan_int8(m, r, words, sms, body=body),
            lambda plan: matvec_cost(plan, B4_COST, m, r, words, sms),
            f"B4 m={m} K={n_in} r={r}", exact=True))
    return res


def phase_kernels(card: str):
    """Phase 2. Returns {(kernel, m, dtype, shape): measurements}."""
    import torch

    from repro_torch.kernels.tiled_matmul import tiled_matmul_plain
    from repro_torch.kernels.tiled_matvec import tiled_matvec_plain

    bw, bf16_peak, f32_peak, int_peak = peaks(card)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    ks = kernels()
    results = {}
    both = ((torch.bfloat16, bf16_peak), (torch.float32, f32_peak))
    for kname, kernel, plain, ms, dtypes in (
            ("B1", ks["B1"], tiled_matvec_plain, B1_MS, both),
            ("B2", ks["B2"], tiled_matmul_plain, B2_MS, both),
            # the fused train path's forward: bf16, m = B*S (the planner picks
            # other split counts there than at the extend shapes)
            ("B2", ks["B2"], tiled_matmul_plain, (TRAIN_BATCH * TRAIN_SEQ,),
             both[:1])):
        for name, k, r, _ in SHAPES:
            packed = torch.randint(0, 2**32, (r, k // 32), generator=gen,
                                   device="cuda", dtype=torch.int64).to(torch.int32)
            for dtype, peak in dtypes:
                for m in ms:
                    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
                    res = check_kernel(kernel, plain, x, packed, bw, peak)
                    results[(kname, m, str(dtype).split(".")[-1], name)] = res
                    print(f"{kname} {name:8s} K={k:5d} r={r:4d} m={m:3d} "
                          f"{str(dtype).split('.')[-1]:8s} max|err|={res['err']:.2e} "
                          f"(max|u|={res['scale']:.1f}) kernel {res['ms']:.4f}ms "
                          f"plain {res['plain_ms']:.4f}ms library "
                          f"{res['library_ms']:.4f}ms bound {res['bound_ms']:.4f}ms "
                          f"| {tflops(res)}", flush=True)
    step = {key: sum((2 * per * TRAIN_LAYERS + (name == "lm_head"))
                     * results[("B2", TRAIN_BATCH * TRAIN_SEQ, "bfloat16", name)][key]
                     for name, _, _, per in SHAPES)
            for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    print(f"B2 per fused train step at L={TRAIN_LAYERS}, m={TRAIN_BATCH * TRAIN_SEQ}, "
          f"bf16 ({2 * 7 * TRAIN_LAYERS + 1} calls): kernel {step['ms']:.3f}ms plain "
          f"{step['plain_ms']:.3f}ms library {step['library_ms']:.3f}ms bound "
          f"{step['bound_ms']:.3f}ms", flush=True)
    m = N_SLOTS * CHUNK
    tick = tick_totals(results, "B2", m, 36, False)
    print(f"B2 per extend tick at L=36, m={m}, bf16 (252 calls): kernel "
          f"{tick['ms']:.3f}ms library {tick['library_ms']:.3f}ms bound "
          f"{tick['bound_ms']:.3f}ms", flush=True)
    for kname, path in (("B3", "xnor"), ("B4", "int8")):
        for m in INT_MS:     # pad bits: n_in = 80 against a pack_bits tile
            check_int_kernel(path, m, 80, 24, gen, bw, int_peak, with_times=False)
        for name, k, r, _ in SHAPES:
            for m in INT_MS:
                res = check_int_kernel(path, m, k, r, gen, bw, int_peak)
                results[(kname, m, "int", name)] = res
                print(f"{kname} {name:8s} K={k:5d} r={r:4d} m={m:3d} {path:8s} "
                      f"exact (max|acc|={res['scale']:.0f}) kernel "
                      f"{res['ms']:.4f}ms plain {res['plain_ms']:.4f}ms library "
                      f"{res['library_ms']:.4f}ms bound {res['bound_ms']:.4f}ms"
                      f"{bodies_line(res)}", flush=True)
        print(f"{kname} n_in=80 r=24 (pad bits) m in {INT_MS}: exact", flush=True)
    for kname, dtype in (("B1", "bfloat16"), ("B3", "int"), ("B4", "int")):
        for m in (N_SLOTS, MATVEC_M):
            tot = tick_totals(results, kname, m, 36, True, dtype)
            print(f"{kname} per decode tick at L=36, m={m}, {dtype} (253 calls): "
                  f"kernel {tot['ms']:.3f}ms (reps {tot['ms_lo']:.3f}-"
                  f"{tot['ms_hi']:.3f}) library {tot['library_ms']:.3f}ms (reps "
                  f"{tot['library_ms_lo']:.3f}-{tot['library_ms_hi']:.3f}) bound "
                  f"{tot['bound_ms']:.3f}ms", flush=True)
    planner_host_cost()
    return results


def planner_host_cost() -> None:
    """Host time of the B1 / B3 / B4 planners over the 253 calls of one
    decode tick at L=36, m = 4, uncached (the planning itself) and as the
    wrappers ask them (cached): the median of 5 timed ticks."""
    from repro_torch.kernels.tiled_matmul import _sm_count
    from repro_torch.kernels.tiled_matvec import plan_matvec
    from repro_torch.kernels.tiled_xnor import plan_int8, plan_xnor

    sms = _sm_count(0)
    calls = [(k // 32, r) for name, k, r, per in SHAPES
             for _ in range(per * 36 + (name == "lm_head"))]
    parts = []
    for kname, plan in (("B1", plan_matvec), ("B3", plan_xnor), ("B4", plan_int8)):
        times = {}
        for how, fn in (("uncached", plan.__wrapped__), ("cached", plan)):
            reps = []
            for _ in range(5):
                t0 = time.perf_counter()
                for words, r in calls:
                    fn(N_SLOTS, r, words, sms)
                reps.append(time.perf_counter() - t0)
            times[how] = 1e3 * sorted(reps)[2]
        parts.append(f"{kname} {plan.__name__} {times['uncached']:.3f}ms uncached, "
                     f"{times['cached']:.4f}ms cached")
    print(f"planner host time per decode tick at L=36, m={N_SLOTS} ({len(calls)} "
          f"calls, median of 5): " + "; ".join(parts), flush=True)


def family_shapes(arch: str):
    """FAMILY_SHAPES[arch] keyed as phase 2b stores its measurements (by
    (K, r), so that two configs' equal shapes are one measurement)."""
    return tuple((f"K{k} r{r}", k, r, per) for _, k, r, per in FAMILY_SHAPES[arch])


def phase_family_kernels(card: str, results) -> None:
    """Phase 2b: the planners' picks of B1-B4 at every (K, r) of the other
    dense configs that granite-8b has not, against the plain version (B1 at
    m in FAMILY_MS and B2 at the extend tick's m, bf16 and f32, within
    RTOL; B3 / B4 at m in FAMILY_MS, equal), each timed beside the plain
    version, the library yardstick and the bound, with the pick printed.
    No body survey. Adds to ``results``; prints qwen1.5-32b's totals per
    decode and extend tick."""
    import torch

    from repro_torch.kernels.tiled_matmul import tiled_matmul_plain
    from repro_torch.kernels.tiled_matvec import tiled_matvec_plain

    t0 = time.perf_counter()
    bw, bf16_peak, f32_peak, int_peak = peaks(card)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    ks = kernels()
    seen = {(k, r) for _, k, r, _ in SHAPES}
    for arch in FAMILY_SHAPES:
        for (key, k, r, _), (name, *_) in zip(family_shapes(arch), FAMILY_SHAPES[arch]):
            if (k, r) in seen:
                continue
            seen.add((k, r))
            packed = torch.randint(0, 2**32, (r, k // 32), generator=gen,
                                   device="cuda", dtype=torch.int64).to(torch.int32)
            for kname, plain, ms in (("B1", tiled_matvec_plain, FAMILY_MS),
                                     ("B2", tiled_matmul_plain, (N_SLOTS * CHUNK,))):
                for dtype, peak in ((torch.bfloat16, bf16_peak),
                                    (torch.float32, f32_peak)):
                    dt = str(dtype).split(".")[-1]
                    for m in ms:
                        x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
                        res = check_kernel(ks[kname], plain, x, packed, bw, peak,
                                           survey=False)
                        results[(kname, m, dt, key)] = res
                        print(f"{kname} {arch} {name:8s} K={k:5d} r={r:5d} m={m:3d} "
                              f"{dt:8s} max|err|={res['err']:.2e} (max|u|="
                              f"{res['scale']:.1f}) kernel {res['ms']:.4f}ms plain "
                              f"{res['plain_ms']:.4f}ms library {res['library_ms']:.4f}ms "
                              f"bound {res['bound_ms']:.4f}ms{bodies_line(res)}",
                              flush=True)
            del packed
            for kname, path in (("B3", "xnor"), ("B4", "int8")):
                for m in FAMILY_MS:
                    res = check_int_kernel(path, m, k, r, gen, bw, int_peak,
                                           survey=False)
                    results[(kname, m, "int", key)] = res
                    print(f"{kname} {arch} {name:8s} K={k:5d} r={r:5d} m={m:3d} "
                          f"{path:8s} exact (max|acc|={res['scale']:.0f}) kernel "
                          f"{res['ms']:.4f}ms plain {res['plain_ms']:.4f}ms library "
                          f"{res['library_ms']:.4f}ms bound {res['bound_ms']:.4f}ms"
                          f"{bodies_line(res)}", flush=True)
    for arch, n_layers in FAMILY_TICK_LAYERS.items():
        shapes = family_shapes(arch)
        calls = sum(per for *_, per in shapes) * n_layers
        m = N_SLOTS * CHUNK
        tot = tick_totals(results, "B2", m, n_layers, False, shapes=shapes)
        print(f"B2 {arch} per extend tick, m={m}, bf16 ({calls} calls): "
              f"kernel {tot['ms']:.3f}ms plain {tot['plain_ms']:.3f}ms library "
              f"{tot['library_ms']:.3f}ms bound {tot['bound_ms']:.3f}ms", flush=True)
        for kname, dtype in (("B1", "bfloat16"), ("B3", "int"), ("B4", "int")):
            for m in (N_SLOTS, MATVEC_M):
                tot = tick_totals(results, kname, m, n_layers, True, dtype, shapes)
                print(f"{kname} {arch} per decode tick, m={m}, {dtype} "
                      f"({calls + 1} calls): kernel {tot['ms']:.3f}ms (reps "
                      f"{tot['ms_lo']:.3f}-{tot['ms_hi']:.3f}) plain "
                      f"{tot['plain_ms']:.3f}ms library "
                      f"{tot['library_ms']:.3f}ms (reps {tot['library_ms_lo']:.3f}-"
                      f"{tot['library_ms_hi']:.3f}) bound {tot['bound_ms']:.3f}ms",
                      flush=True)
    torch.cuda.empty_cache()
    print(f"phase 2b (dense, SSM and hybrid family shapes): "
          f"{time.perf_counter() - t0:.1f}s", flush=True)


def tick_totals(results, kname: str, m: int, n_layers: int, with_head: bool,
                dtype: str = "bfloat16", shapes=SHAPES):
    """Sum the per-shape measurements over the calls of one engine tick."""
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               bytes_ms=0.0, ops_ms=0.0, ms_lo=0.0, ms_hi=0.0,
               library_ms_lo=0.0, library_ms_hi=0.0)
    for name, _, _, per_layer in shapes:
        n = per_layer * n_layers + (1 if name == "lm_head" and with_head else 0)
        res = results[(kname, m, dtype, name)]
        for key in tot:
            tot[key] += n * res[key]
    return tot


def layer_calls(cfg) -> int:
    """Tiled projections of every layer of one decode tick (the LM head
    apart): an attention layer's q, k, v, o, an RG-LRU layer's in_x,
    in_gate, out, w_a, w_i, each with the MLP's (gate, up, down, or up,
    down); a mamba2 layer's in_proj and out_proj; an MoE layer's
    MOE_DENSE_CALLS."""
    if cfg.family == "moe":
        return MOE_DENSE_CALLS[cfg.name] * cfg.n_layers
    if cfg.family == "ssm":
        return 2 * cfg.n_layers
    mlp = 3 if cfg.gated_mlp else 2
    kinds = ([cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.n_layers)]
             if cfg.family == "hybrid" else ["attn"] * cfg.n_layers)
    return sum((5 if k == "rec" else 4) + mlp for k in kinds)


def check_caches(eng, cfg, label: str) -> None:
    """The engine's caches by family: a page pool only with full attention;
    K/V pools and rings in bf16 (int8 codes with f32 scales under an int8
    KV config); recurrent carries f32."""
    import torch

    from repro_torch.nn import module as mod

    if (eng.pool is not None) != eng.model.has_full_attn:
        fail(f"{label}: page pool {eng.pool} with has_full_attn "
             f"{eng.model.has_full_attn}")
    int8 = cfg.kv_dtype == "int8"
    want = {"k": torch.int8 if int8 else torch.bfloat16,
            "v": torch.int8 if int8 else torch.bfloat16,
            "ks": torch.float32, "vs": torch.float32,
            "h": torch.float32, "conv": torch.float32}
    got = {"/".join(p): v.dtype for c in eng.caches for p, v in mod.walk(c)}
    bad = {k: v for k, v in got.items() if v != want[k.split("/")[-1]]}
    if bad or not got:
        fail(f"{label}: cache leaves of unexpected type {bad} (of {got})")


def serve_engine(s_model, sp, path: str, n_slots: int = N_SLOTS):
    from repro_torch.serve.engine import BatchedEngine, ServeConfig

    return BatchedEngine(s_model, sp, ServeConfig(
        n_slots=n_slots, max_len=128, chunk_tokens=CHUNK, page_tokens=16,
        compute_path=path))


def release() -> None:
    """Collect a dropped engine and its graphs (its tick functions and
    graphs refer to each other, so it takes a collection) and return the
    memory to the card."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def drive(eng, cfg, prompts, max_tokens: int):
    """Submit ``prompts`` (``max_tokens`` greedy tokens each) and drain,
    with every launch counter set to 0 just before and read just after.
    Returns the measurements of the run."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import drain, latency_report
    from repro_torch.serve.sampling import SamplingParams

    reqs = [eng.submit(p, SamplingParams(max_tokens=max_tokens)) for p in prompts]
    zero_counters()
    ticks, dt, tick_ends = drain(eng, reqs)
    counts = read_counters()
    torch.cuda.synchronize()
    st = eng.stats()
    ttfts, itls = latency_report(reqs, tick_ends)
    if not all(r.done and len(r.output) == max_tokens for r in reqs):
        fail(f"{cfg.name}: not every request finished with {max_tokens} tokens")
    if not all(0 <= t < cfg.vocab for r in reqs for t in r.output):
        fail(f"{cfg.name}: a sampled token is outside the vocabulary")
    tok = sum(len(r.output) for r in reqs)
    return dict(reqs=reqs, ticks=ticks, dt=dt, counts=counts, st=st, tok=tok,
                tokens=[r.output for r in reqs],
                steps=[r.token_steps for r in reqs],
                ttft=1e3 * float(np.mean(ttfts)), ttft_max=1e3 * float(np.max(ttfts)),
                itl=1e3 * float(np.mean(itls)), itl_max=1e3 * float(np.max(itls)))


def serve_run(cfg, s_model, sp, path: str, requests: int = 8,
              max_tokens: int = 16, profile_ticks: int = 3, wide: bool = True):
    """Drive ``requests`` prompts of 3-100 tokens, ``max_tokens`` greedy
    tokens each, through a BatchedEngine under ``path``, cold (eager ticks)
    and then warm (a new engine, ``warmup()``, the same prompts: the ticks
    replay CUDA graphs). Cold: every launch counter is 0 just before the run
    and read just after it; asserts the caches' families and types
    (:func:`check_caches`), that the path's decode kernel took every
    m <= 32 projection, B2 every extend, and no other kernel ran. Warm: see
    :func:`warm_run`. Then traces ``profile_ticks`` 4-slot decode ticks cold
    and warm and, with ``wide``, one of 32 slots. Returns the cold counts."""
    import numpy as np

    from repro_torch.launch.serve import synthetic_prompts

    eng = serve_engine(s_model, sp, path)
    check_caches(eng, cfg, f"{cfg.name} {path}")
    rng = np.random.default_rng(0)
    prompts = synthetic_prompts(rng, requests, cfg.vocab, 3, 101)
    cold = drive(eng, cfg, prompts, max_tokens)
    del eng
    release()
    counts, st = cold["counts"], cold["st"]
    label = f"{cfg.name} {path}"
    if st["decode_ticks"] == 0 or st["extend_ticks"] == 0:
        fail(f"{label}: the run had {st['decode_ticks']} decode and "
             f"{st['extend_ticks']} extend ticks; both must run")
    own = PATH_KERNEL[path]
    need = ((layer_calls(cfg) + 1) * st["decode_ticks"]
            + st["extend_ticks"])
    others = [k for k in ("B1", "B3", "B4", "B5", "B6") if k != own]
    if (counts[own] != need or counts["B2"] < st["extend_ticks"]
            or any(counts[k] for k in others)):
        fail(f"{label}: launch counters {counts}; need {own} = {need}, B2 >= "
             f"{st['extend_ticks']}, {others} = 0: the main path did not go "
             f"through the kernels")
    print(f"serve [{label}] cold: {requests} requests, {cold['tok']} tokens in "
          f"{cold['ticks']} ticks ({st['extend_ticks']} extend, {st['decode_ticks']} "
          f"decode), {cold['dt']:.3f}s, {cold['tok'] / cold['dt']:.1f} tok/s | TTFT "
          f"mean {cold['ttft']:.1f}ms max {cold['ttft_max']:.1f}ms | ITL mean "
          f"{cold['itl']:.2f}ms max {cold['itl_max']:.2f}ms | extend tick "
          f"{st['extend_ms_mean']:.2f}ms decode tick {st['decode_ms_mean']:.2f}ms | "
          f"launches " + " ".join(f"{k}={v}" for k, v in counts.items()), flush=True)
    print(f"serve [{label}]: first requests' tokens {cold['tokens'][:2]}")
    warm = warm_run(cfg, s_model, sp, path, prompts, max_tokens, cold)
    if profile_ticks:
        for ms, is_warm in ((st["decode_ms_mean"], False),
                            (warm["st"]["decode_ms_mean"], True)):
            profile_decode(s_model, sp, cfg, ms, path, n_ticks=profile_ticks,
                           warm=is_warm)
    if wide:   # the widest decode tick: every projection at m = 32
        for is_warm in (False, True):
            profile_decode(s_model, sp, cfg, None, path, n_ticks=1,
                           n_slots=WIDE_SLOTS, warm=is_warm)
    return counts


def warm_run(cfg, s_model, sp, path: str, prompts, max_tokens: int, cold):
    """The cold run's prompts through a new engine after ``warmup()``. The
    launch counters are zeroed before ``warmup()`` (its warm-up runs and
    capture launch every kernel of both ticks: WARM_RUNS + 1 ticks of each)
    and again after it: the warm drain must leave them at 0, and
    ``TRACE_COUNTS`` where it was, since every tick replays a graph. Its
    greedy tokens, their ticks and the tick count must equal the cold
    run's. Prints capture seconds, the graph pool's device bytes and the
    cold and warm tick times, tok/s, TTFT and ITL."""
    import torch

    from repro_torch.serve.engine import TRACE_COUNTS
    from repro_torch.serve.graphs import WARM_RUNS

    label = f"{cfg.name} {path}"
    eng = serve_engine(s_model, sp, path)
    torch.cuda.synchronize()
    alloc, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    zero_counters()
    timings = eng.warmup()
    captured = read_counters()
    alloc = torch.cuda.memory_allocated() - alloc
    reserved = torch.cuda.memory_reserved() - reserved
    own, per_layer = PATH_KERNEL[path], layer_calls(cfg)
    # decode: every projection and the head; extend: B2, its head on `own`
    want = {k: 0 for k in captured}
    want[own] = (WARM_RUNS + 1) * (per_layer + 2)
    want["B2"] = (WARM_RUNS + 1) * per_layer
    if captured != want or not eng.aot_warm:
        fail(f"{label}: warmup launched {captured}, expected {want} "
             f"({WARM_RUNS} warm-up runs and one capture of each tick)")
    traces = TRACE_COUNTS.copy()
    run = drive(eng, cfg, prompts, max_tokens)
    st = run["st"]
    del eng
    release()
    if any(run["counts"].values()) or TRACE_COUNTS != traces:
        fail(f"{label} warm: the drain launched {run['counts']} through the "
             f"wrappers and moved TRACE_COUNTS {dict(traces)} -> "
             f"{dict(TRACE_COUNTS)}: a tick did not replay its graph")
    if (run["tokens"], run["steps"], run["ticks"]) != (
            cold["tokens"], cold["steps"], cold["ticks"]):
        fail(f"{label} warm: greedy tokens or their ticks differ from the cold "
             f"run's: {run['tokens'][:2]} vs {cold['tokens'][:2]}")
    cst = cold["st"]
    print(f"serve [{label}] warm: capture "
          + ", ".join(f"{k} {v:.3f}s" for k, v in timings.items())
          + f", graph pool {alloc / 1e6:+.1f} MB allocated ({reserved / 1e6:+.1f} "
          f"MB reserved) | cold -> warm: decode tick {cst['decode_ms_mean']:.2f} -> "
          f"{st['decode_ms_mean']:.2f}ms, extend tick {cst['extend_ms_mean']:.2f} -> "
          f"{st['extend_ms_mean']:.2f}ms, {cold['tok'] / cold['dt']:.1f} -> "
          f"{run['tok'] / run['dt']:.1f} tok/s, TTFT mean {cold['ttft']:.1f} -> "
          f"{run['ttft']:.1f}ms (max {run['ttft_max']:.1f}), ITL mean "
          f"{cold['itl']:.2f} -> {run['itl']:.2f}ms (max {run['itl_max']:.2f}) | "
          f"greedy tokens byte-identical to cold over {run['ticks']} ticks; no "
          f"launch and no TRACE_COUNTS move in the warm drain", flush=True)
    return run


def phase_serve(cfg):
    """Phase 3: granite-8b at published width through the entry points,
    under each compute path on one export of the weights."""
    import torch

    from repro_torch.configs import build_model
    from repro_torch.launch.serve import build_serving
    from repro_torch.nn.context import SERVE, ModelContext
    from repro_torch.serve.weights import serving_bytes

    t0 = time.perf_counter()
    s_model, sp, master_b = build_serving(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    ship_b = serving_bytes(sp)
    print(f"serve {cfg.name}: L={cfg.n_layers} d={cfg.d_model} heads={cfg.n_heads}/"
          f"{cfg.n_kv} d_ff={cfg.d_ff} vocab={cfg.vocab} p={cfg.tbn.p} bf16: masters "
          f"{master_b / 1e9:.2f}GB -> shipped {ship_b / 1e9:.3f}GB in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    launches = {}
    for path in PATH_KERNEL:
        if path != "float":
            s_model = build_model(cfg, ModelContext(
                policy=cfg.tbn, mode=SERVE, compute_dtype=torch.bfloat16,
                device="cuda", compute_path=path))
        counts = serve_run(cfg, s_model, sp, path)
        launches[PATH_KERNEL[path]] = counts[PATH_KERNEL[path]]
        if path == "float":
            launches["B2"] = counts["B2"]
    return sp, launches


def device_time_by_name(prof):
    """(device events, {kernel name: (ms, count)}) of a finished profile."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in events:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
    return events, by_name


# compute path -> kernel-name fragments of its decode kernel: the CUDA-core
# body, the tensor-core body (decode_mma.cuh's mma_kernel over the source's
# Op) and, for B1 / B4, its split pass (B2's pass too, but no decode-only
# tick runs B2; B3 adds its K splits in a cluster, in the same kernel)
PATH_KERNEL_NAMES = {"float": ("matvec_kernel", "Bf16Op", "sum_splits_kernel<float>"),
                     "xnor": ("xnor_kernel", "XnorOp"),
                     "int8": ("int8_kernel", "S8Op", "sum_splits_kernel<int>")}


def profile_decode(s_model, sp, cfg, tick_ms, path: str, n_ticks: int = 3,
                   n_slots: int = N_SLOTS, warm: bool = False):
    """Trace ``n_ticks`` decode-only ticks of ``n_slots`` slots with
    torch.profiler: device busy time per tick (sum of kernel durations; one
    stream, so no overlap) beside the unprofiled decode tick of the serve
    run (``tick_ms``, None for a tick size the serve run does not have),
    the decode kernel's share of it, and the top kernels. With ``warm`` the
    engine is warmed up first, so the traced ticks replay its decode graph:
    the decode kernel must then be among the device events."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.sampling import SamplingParams

    eng = serve_engine(s_model, sp, path, n_slots)
    if warm:
        eng.warmup()
    rng = np.random.default_rng(2)
    prompt = max(1, CHUNK // n_slots)   # all prompts in one extend tick's budget
    for _ in range(n_slots):
        eng.submit(rng.integers(0, cfg.vocab, size=prompt),
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
    del eng
    release()
    events, by_name = device_time_by_name(prof)
    busy_ms = sum(t for t, _ in by_name.values()) / n_ticks
    label = f"{cfg.name} {path}, {n_slots} slots, {'warm' if warm else 'cold'}"
    own = sum(t for k, (t, _) in by_name.items()
              if any(f in k for f in PATH_KERNEL_NAMES[path])) / n_ticks
    if warm and own == 0:
        fail(f"profile [{label}]: no {PATH_KERNEL[path]} kernel among the "
             f"{len(events)} device events of the replayed ticks")
    if not events:
        print(f"profile [{label}]: the profiler recorded no device events "
              f"(device time not measured)")
        return
    wall = ("" if tick_ms is None else f" of {tick_ms:.2f} ms wall (serve run) "
            f"-> device idle share {1 - busy_ms / tick_ms:.3f}")
    print(f"profile [{label}]: decode tick device busy {busy_ms:.3f} ms{wall}; "
          f"{PATH_KERNEL[path]} {own:.3f} ms ({own / busy_ms:.3f} of busy); "
          f"{len(events) / n_ticks:.0f} kernels/tick")
    if cfg.family == "moe":
        moe_shares(s_model, sp, cfg, n_slots, by_name, busy_ms, n_ticks)
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
        print(f"  {t / n_ticks:8.3f} ms/tick {n // n_ticks:5d}x  {name[:90]}")


MOE_PARTS = {}


def moe_parts(s_model, sp, n_slots: int):
    """One MoE layer's routed-expert work at a decode tick of ``n_slots``
    tokens (capacity n_slots * k a bank): device ms of the rebuild of its
    three banks (``ExpertBank.effective``) and of its three batched products
    (``torch.bmm``), each timed as a CUDA graph of 5 calls, median of 5
    replays; and the kernel names each launches (one profiled call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.nn import module as mod

    key = (s_model.cfg.name, n_slots)     # the same banks under every path
    if key in MOE_PARTS:
        return MOE_PARTS[key]
    seg = len(s_model.segments) - 1
    layer = s_model.segments[seg].block.ffn
    p = mod.map_tree(lambda v: v[0], sp[f"seg{seg}"]["ffn"])
    banks = ((layer.up, p["up"]), (layer.gate_bank, p["gate"]),
             (layer.down, p["down"]))
    cap, cd = n_slots * layer.top_k, s_model.ctx.compute_dtype
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    xbuf = torch.randn((layer.n_experts, cap, layer.d_model), generator=gen,
                       device="cuda").to(cd)
    h = torch.randn((layer.n_experts, cap, layer.d_ff), generator=gen,
                    device="cuda").to(cd)
    with torch.no_grad():
        w = [bank.effective(q) for bank, q in banks]

        def rebuild():
            for bank, q in banks:
                bank.effective(q)

        def products():
            torch.bmm(xbuf, w[0].transpose(1, 2))
            torch.bmm(xbuf, w[1].transpose(1, 2))
            torch.bmm(h, w[2].transpose(1, 2))

        out = {"rebuild_ms": time_ms(rebuild, iters=5, reps=5),
               "products_ms": time_ms(products, iters=5, reps=5)}
        for name, fn in (("rebuild", rebuild), ("products", products)):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            out[name + "_names"] = set(device_time_by_name(prof)[1])
    del w, xbuf, h
    release()
    MOE_PARTS[key] = out
    return out


def moe_shares(s_model, sp, cfg, n_slots: int, by_name, busy_ms: float,
               n_ticks: int) -> None:
    """The routed experts' share of a profiled decode tick, two ways: the
    pieces of one layer timed alone (``moe_parts``) times the MoE layers,
    over the tick's busy time; and the tick's device time under the kernel
    names those pieces launch (an upper bound: the attention and norms may
    launch kernels of the same names)."""
    parts = moe_parts(s_model, sp, n_slots)
    n_moe = cfg.n_layers - int(cfg.moe.first_dense)
    line = []
    for what in ("rebuild", "products"):
        timed_ms = parts[what + "_ms"] * n_moe
        named = sum(t for k, (t, _) in by_name.items()
                    if k in parts[what + "_names"]) / n_ticks
        line.append(f"{what} {timed_ms:.3f} ms timed alone x {n_moe} layers "
                    f"({timed_ms / busy_ms:.3f} of busy), {named:.3f} ms under "
                    f"its {len(parts[what + '_names'])} kernel names "
                    f"({named / busy_ms:.3f})")
    print(f"  routed experts: " + "; ".join(line), flush=True)


def int_layers_card_vs_cpu(cfg):
    """Integer paths at the layer level: ``tiled_dense_infer`` on the card
    against the CPU at every full-width shape, m = 4 rows of f32."""
    import torch

    from repro_torch.core.packing import pack_bits
    from repro_torch.core.tiling import plan_tiling
    from repro_torch.kernels import ops
    from repro_torch.kernels import tiled_xnor as x8

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    p = cfg.tbn.p
    for path in ("xnor", "int8"):
        worst = 0.0
        for name, k, r, _ in SHAPES:
            spec = plan_tiling((p * r, k), p=p, min_size=1, alpha_mode="tile",
                               alpha_source="W")
            x = torch.randn((N_SLOTS, k), generator=gen, device="cuda")
            rows = pack_bits(torch.randn((r, k), generator=gen, device="cuda"))
            alpha = torch.rand((p,), generator=gen, device="cuda") + 0.1
            quant = x8.quantize_sign if path == "xnor" else x8.quantize_int8
            a_card, a_cpu = quant(x, k)[0], quant(x.cpu(), k)[0]
            if not torch.equal(a_card.cpu(), a_cpu):
                fail(f"{path} {name}: quantized activations differ card vs CPU")
            if path == "xnor":
                acc = x8.tiled_xnor_matvec_unique(a_card, rows, n_in=k).cpu()
                want = x8.tiled_xnor_matvec_unique(a_cpu, rows.cpu(), n_in=k)
            else:
                acc = x8.tiled_int8_matvec_unique(a_card, rows).cpu()
                want = x8.tiled_int8_matvec_unique(a_cpu, rows.cpu())
            if not torch.equal(acc, want):
                fail(f"{path} {name}: int32 accumulators differ card vs CPU")
            got = ops.tiled_dense_infer(x, rows, alpha, spec,
                                        compute_path=path).cpu()
            ref = ops.tiled_dense_infer(x.cpu(), rows.cpu(), alpha.cpu(), spec,
                                        compute_path=path)
            err = float(((got - ref).abs() / ref.abs().clamp_min(1e-30)).max())
            worst = max(worst, err)
            if not torch.allclose(got, ref, rtol=INT_RTOL, atol=0):
                fail(f"{path} {name}: tiled_dense_infer card vs CPU max rel "
                     f"err {err:.3e} over rtol {INT_RTOL}")
        print(f"layer card vs CPU [{path}] (5 full-width shapes, m={N_SLOTS}, "
              f"f32): quantized operands and int32 accumulators equal, outputs "
              f"max rel err {worst:.2e} (rtol={INT_RTOL}) OK", flush=True)


def phase_card_vs_cpu(cfg, sp):
    """Phase 4: full width, 2 layers, f32, card model vs CPU model."""
    import numpy as np
    import torch

    from repro_torch.configs import build_model
    from repro_torch.nn import module as mod
    from repro_torch.nn.context import SERVE, ModelContext

    int_layers_card_vs_cpu(cfg)
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    sp2 = dict(sp, seg0=mod.map_tree(lambda v: v[:2].contiguous(), sp["seg0"]))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, size=(2, 24))
    nxt = rng.integers(0, cfg.vocab, size=(2, 1))
    params = {dev: mod.map_tree(lambda v: v.to(dev), sp2) for dev in ("cuda", "cpu")}
    for path in PATH_KERNEL:
        out = {}
        for dev in ("cuda", "cpu"):
            model = build_model(cfg2, ModelContext(policy=cfg.tbn, mode=SERVE,
                                                   compute_dtype=torch.float32,
                                                   device=dev, compute_path=path))
            caches = model.init_caches(2, 64, torch.float32, page_tokens=16,
                                        n_pages=8)
            ptab = torch.arange(8, dtype=torch.int32, device=dev).reshape(2, 4)
            lengths = torch.zeros(2, dtype=torch.int32, device=dev)
            n_new = torch.tensor([24, 17], dtype=torch.int32, device=dev)
            with torch.no_grad():
                le, caches, lengths = model.extend(
                    params[dev], torch.from_numpy(tokens).to(dev), caches,
                    lengths, n_new, ptab)
                ld, _, _ = model.decode_step(
                    params[dev], torch.from_numpy(nxt).to(dev), caches,
                    lengths, ptab)
            out[dev] = (le.cpu(), ld.cpu())
        errs = []
        for name, a, b in zip(("extend", "decode"), out["cuda"], out["cpu"]):
            if not torch.isfinite(a).all():
                fail(f"card {name} logits [{path}] are not finite")
            errs.append(float((a - b).abs().max()))
            if path == "float" and not torch.allclose(a, b, rtol=1e-3, atol=1e-3):
                fail(f"card vs CPU {name} logits differ: max|diff| {errs[-1]:.3e}")
        verdict = ("(rtol=atol=1e-3) OK" if path == "float" else
                   "(finite; not held to a tolerance: one flipped sign or "
                   "int8 rounding upstream moves the logits)")
        print(f"model card vs CPU [{path}] (L=2, full width, f32): extend "
              f"max|diff| {errs[0]:.2e}, decode max|diff| {errs[1]:.2e} "
              f"{verdict}", flush=True)


def build_on_card(cfg):
    """``build_serving`` on the card (streamed masters, bf16), with the peak
    of allocated device memory across the build, which must leave room on
    the card. Returns (model, params, master bytes)."""
    import torch

    from repro_torch.launch.serve import build_serving
    from repro_torch.serve.weights import serving_bytes

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s_model, sp, master_b = build_serving(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    peak, card = torch.cuda.max_memory_allocated(), torch.cuda.mem_get_info()[1]
    print(f"serve {cfg.name}: L={cfg.n_layers} d={cfg.d_model} heads={cfg.n_heads}/"
          f"{cfg.n_kv} d_ff={cfg.d_ff} vocab={cfg.vocab} p={cfg.tbn.p} kv "
          f"{cfg.kv_dtype} bf16: masters {master_b / 1e9:.2f}GB -> shipped "
          f"{serving_bytes(sp) / 1e9:.3f}GB, built one master leaf at a time in "
          f"{time.perf_counter() - t0:.1f}s; peak device memory in the build "
          f"{peak / 1e9:.2f}GB of {card / 1e9:.2f}GB", flush=True)
    if peak > 0.9 * card:
        fail(f"{cfg.name}: the build's peak {peak / 1e9:.2f}GB leaves under 10% "
             f"of the card's {card / 1e9:.2f}GB")
    return s_model, sp, master_b


def phase_serve_paths(cfg, phase: str):
    """Phases 4b and 4e: ``cfg`` at its published width and depth (qwen1.5-32b
    with its int8 KV cache; qwen2-moe-a2.7b) under each compute path on one
    streamed export, cold and warm; one 4-slot decode tick traced per path.
    Returns (params, launch counts)."""
    import torch

    from repro_torch.configs import build_model
    from repro_torch.nn.context import SERVE, ModelContext

    t0 = time.perf_counter()
    s_model, sp, _ = build_on_card(cfg)
    launches = dict.fromkeys(("B1", "B2", "B3", "B4"), 0)
    for path in PATH_KERNEL:
        if path != "float":
            s_model = build_model(cfg, ModelContext(
                policy=cfg.tbn, mode=SERVE, compute_dtype=torch.bfloat16,
                device="cuda", compute_path=path))
        counts = serve_run(cfg, s_model, sp, path, profile_ticks=1, wide=False)
        for k in (PATH_KERNEL[path], "B2"):
            launches[k] += counts[k]
    print(f"phase {phase} ({cfg.name} serve): {time.perf_counter() - t0:.1f}s",
          flush=True)
    return sp, launches


def qwen_two_layers(cfg, sp, dev: str, kv_dtype: str, pools=None):
    """qwen1.5-32b cut to 2 layers, f32, on ``dev``: one extend of two
    slots (24 and 17 of 24 columns) and one decode step through an 8-page
    table. With ``pools``, the decode step reads those K/V pools (another
    device's, after its extend) in place of its own. Returns (extend
    logits, decode logits, the pools after the extend), on the CPU."""
    import numpy as np
    import torch

    from repro_torch.configs import build_model
    from repro_torch.nn import module as mod
    from repro_torch.nn.context import SERVE, ModelContext

    cfg2 = dataclasses.replace(cfg, n_layers=2, kv_dtype=kv_dtype)
    params = mod.map_tree(lambda v: v[:2].to(dev), sp.pop("seg0"))
    params = dict(mod.map_tree(lambda v: v.to(dev), sp), seg0=params)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 24))).to(dev)
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 1))).to(dev)
    model = build_model(cfg2, ModelContext(policy=cfg.tbn, mode=SERVE,
                                           compute_dtype=torch.float32, device=dev))
    caches = model.init_caches(2, 64, torch.float32, page_tokens=16,
                                n_pages=8)
    ptab = torch.arange(8, dtype=torch.int32, device=dev).reshape(2, 4)
    lengths = torch.zeros(2, dtype=torch.int32, device=dev)
    n_new = torch.tensor([24, 17], dtype=torch.int32, device=dev)
    with torch.no_grad():
        le, caches, lengths = model.extend(params, tokens, caches, lengths,
                                           n_new, ptab)
        # the 8 mapped pages; the last page takes the dropped writes
        own = {n: v[:, :8].to("cpu", copy=True) for n, v in caches[0].items()}
        for n, v in (pools or {}).items():
            caches[0][n][:, :8].copy_(v)
        ld, _, _ = model.decode_step(params, nxt, caches, lengths, ptab)
    return le.cpu(), ld.cpu(), own


def phase_qwen_card_vs_cpu(cfg, sp):
    """Phase 4c: qwen1.5-32b at full width, 2 layers, f32, on the card
    (kernels) against the CPU (plain versions).

    * ``quantize_kv`` on one K tensor: codes and scales equal.
    * Float K/V pools (``kv_dtype`` "bf16": the compute dtype): extend and
      decode logits at rtol = atol = 1e-3, as phase 4 holds granite-8b.
    * The int8 KV cache: after the extend, the pools' codes within one
      step (the count that differ is printed) and layer 0's scales (its
      K/V rows differ by summation order only) at rtol 1e-5;
      the decode step on the CPU from the card's pools against the card's
      at rtol = atol = 1e-3. The int8 KV logits of each device from its own
      pools are printed and checked finite only: a K/V value that a
      reordered f32 sum moves across a rounding boundary moves its code
      by one step (1/127 of the row's amax), and the logits with it by
      ~5e-3, while the decode step from the same pools agrees to ~1e-5
      (PERF.md §6)."""
    import torch

    from repro_torch.nn.attention import quantize_kv

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    k = 3 * torch.randn((2, 24, cfg.n_kv, cfg.d_model // cfg.n_heads),
                        generator=gen, device="cuda")
    q_card, s_card = quantize_kv(k)
    q_cpu, s_cpu = quantize_kv(k.cpu())
    if not (torch.equal(q_card.cpu(), q_cpu) and torch.equal(s_card.cpu(), s_cpu)):
        fail("quantize_kv: card codes or scales differ from the CPU's")
    print(f"quantize_kv card vs CPU ({tuple(k.shape)} f32): codes and scales "
          f"equal", flush=True)

    def held(what, a, b):
        err = float((a - b).abs().max())
        if not torch.isfinite(a).all() or not torch.allclose(a, b, rtol=1e-3, atol=1e-3):
            fail(f"{cfg.name} card vs CPU {what} logits differ: max|diff| {err:.3e}")
        return err

    card = qwen_two_layers(cfg, dict(sp), "cuda", "bf16")
    cpu = qwen_two_layers(cfg, dict(sp), "cpu", "bf16")
    errs = [held(f"{w} (float K/V)", a, b)
            for w, a, b in zip(("extend", "decode"), card, cpu)]
    card = qwen_two_layers(cfg, dict(sp), "cuda", "int8")
    cpu = qwen_two_layers(cfg, dict(sp), "cpu", "int8", pools=card[2])
    n_codes, n_diff = 0, 0
    for name in ("k", "v"):
        a, b = card[2][name], cpu[2][name]
        if a.dtype != torch.int8 or b.dtype != torch.int8:
            fail(f"{cfg.name}: the {name} pool holds {a.dtype} / {b.dtype}, not int8")
        d = (a.int() - b.int()).abs()
        n_codes, n_diff = n_codes + d.numel(), n_diff + int((d > 0).sum())
        if int(d.max()) > 1:
            fail(f"{cfg.name}: {name} codes card vs CPU differ by {int(d.max())}")
    worst_s = [0.0, 0.0]       # per layer
    for name in ("ks", "vs"):
        for layer, (a, b) in enumerate(zip(card[2][name], cpu[2][name])):
            rel = float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
            worst_s[layer] = max(worst_s[layer], rel)
        if worst_s[0] > 1e-5:
            fail(f"{cfg.name}: layer 0 {name} scales card vs CPU over rtol 1e-5")
    dec = held("decode (int8 K/V, the card's pools)", card[1], cpu[1])
    if not torch.isfinite(card[0]).all():
        fail(f"{cfg.name}: card extend logits (int8 K/V) are not finite")
    own = float((card[0] - cpu[0]).abs().max())
    print(f"model card vs CPU [{cfg.name} float, L=2, full width, f32]: float K/V "
          f"extend max|diff| {errs[0]:.2e}, decode {errs[1]:.2e} (rtol=atol=1e-3) "
          f"OK; int8 K/V: codes within 1 step, {n_diff} of {n_codes} differ, "
          f"scales max rel diff {worst_s[0]:.2e} in layer 0 (rtol 1e-5), "
          f"{worst_s[1]:.2e} in layer 1 (after layer 0's code steps), decode "
          f"from the card's "
          f"pools max|diff| {dec:.2e} (rtol=atol=1e-3) OK, extend from each "
          f"device's own codes max|diff| {own:.2e} (finite; not held); "
          f"{time.perf_counter() - t0:.1f}s", flush=True)


def phase_serve_family(arch: str, phase: str = "4d", profile_ticks: int = 0,
                       n_layers=None):
    """Phases 4d and 4f: ``arch`` at its published width and depth (or
    ``n_layers``), float path, 4 requests of 8 greedy tokens, through the
    same counter checks, ``profile_ticks`` decode ticks traced cold and
    warm. Returns the launch counts."""
    import torch

    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    s_model, sp, _ = build_on_card(cfg)
    counts = serve_run(cfg, s_model, sp, "float", requests=4, max_tokens=8,
                       profile_ticks=profile_ticks, wide=False)
    del s_model, sp
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase {phase} ({arch} serve, L={cfg.n_layers}): "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return counts


def moe_two_layers(cfg, sp, dev: str, calls: list):
    """qwen2-moe-a2.7b cut to MOE_CHECK_LAYERS layers, f32, on ``dev``: one
    extend of two slots (24 and 17 of 24 columns) and one decode step
    through an 8-page table. Every MoE serve call appends its routing to
    ``calls``. Returns (extend logits, decode logits) on the CPU."""
    import numpy as np
    import torch

    from repro_torch.configs import build_model
    from repro_torch.nn import module as mod
    from repro_torch.nn.context import SERVE, ModelContext

    n = MOE_CHECK_LAYERS
    cfg2 = dataclasses.replace(cfg, n_layers=n)
    params = dict(sp, seg0=mod.map_tree(lambda v: v[:n], sp["seg0"]))
    params = mod.map_tree(lambda v: v.to(dev), params)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 24))).to(dev)
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 1))).to(dev)
    model = build_model(cfg2, ModelContext(policy=cfg.tbn, mode=SERVE,
                                           compute_dtype=torch.float32, device=dev))
    caches = model.init_caches(2, 64, torch.float32, page_tokens=16,
                                n_pages=8)
    ptab = torch.arange(8, dtype=torch.int32, device=dev).reshape(2, 4)
    lengths = torch.zeros(2, dtype=torch.int32, device=dev)
    n_new = torch.tensor([24, 17], dtype=torch.int32, device=dev)
    with torch.no_grad(), recording_routing(calls):
        le, caches, lengths = model.extend(params, tokens, caches, lengths,
                                           n_new, ptab)
        ld, _, _ = model.decode_step(params, nxt, caches, lengths, ptab)
    return le.cpu(), ld.cpu()


@contextlib.contextmanager
def recording_routing(calls: list):
    """Within the block, every ``MoE`` serve call appends to ``calls`` its
    router probabilities, expert ids and dispatch positions (on the CPU)."""
    from repro_torch.nn import moe

    route, dispatch = moe.MoE._route, moe.MoE._dispatch_serve

    def rec_route(layer, router, xg):
        out = route(layer, router, xg)
        calls.append({"probs": out[0].cpu(), "ids": out[2].cpu()})
        return out

    def rec_dispatch(layer, xg, top_idx):
        xbuf, meta = dispatch(layer, xg, top_idx)
        calls[-1]["pos"] = meta[1].cpu()
        return xbuf, meta

    moe.MoE._route, moe.MoE._dispatch_serve = rec_route, rec_dispatch
    try:
        yield calls
    finally:
        moe.MoE._route, moe.MoE._dispatch_serve = route, dispatch


def phase_moe_card_vs_cpu(cfg, sp):
    """Phase 4g: qwen2-moe-a2.7b at full width, MOE_CHECK_LAYERS layers,
    f32: one extend and one decode step on the card (kernels) against the
    CPU model (plain versions). The routing of every MoE call (top-k expert
    ids and dispatch positions) must be equal; where it is not, the phase
    names the first token that differs and the gap between its k-th and
    (k+1)-th router probability on the CPU. Logits at rtol = atol = 1e-3."""
    import torch

    t0 = time.perf_counter()
    routes = {}
    logits = {}
    for dev in ("cuda", "cpu"):
        routes[dev] = []
        logits[dev] = moe_two_layers(cfg, sp, dev, routes[dev])
    k = cfg.moe.top_k
    if len(routes["cuda"]) != len(routes["cpu"]) or not routes["cpu"]:
        fail(f"{cfg.name}: {len(routes['cuda'])} MoE calls on the card, "
             f"{len(routes['cpu'])} on the CPU")
    n_tok = 0
    for i, (a, b) in enumerate(zip(routes["cuda"], routes["cpu"])):
        n_tok += a["ids"].shape[0]
        for key in ("ids", "pos"):
            if not torch.equal(a[key], b[key]):
                bad = (a[key] != b[key]).reshape(a["ids"].shape[0], -1).any(-1)
                t = int(bad.nonzero()[0, 0])
                top = torch.sort(b["probs"][t], descending=True).values
                fail(f"{cfg.name}: MoE call {i} ({'extend' if i < MOE_CHECK_LAYERS else 'decode'}"
                     f", layer {i % MOE_CHECK_LAYERS}): {key} differ card vs CPU "
                     f"first at token {t}: card ids {a['ids'][t].tolist()} vs CPU "
                     f"{b['ids'][t].tolist()}; the CPU's k-th and (k+1)-th "
                     f"probabilities {float(top[k - 1]):.9g} and {float(top[k]):.9g} "
                     f"(gap {float(top[k - 1] - top[k]):.3e})")
    gaps = min(float((torch.sort(c["probs"], descending=True).values[:, k - 1]
                      - torch.sort(c["probs"], descending=True).values[:, k]).min())
               for c in routes["cpu"])
    errs = []
    for what, a, b in zip(("extend", "decode"), logits["cuda"], logits["cpu"]):
        err = float((a - b).abs().max())
        errs.append(err)
        if not torch.isfinite(a).all() or not torch.allclose(a, b, rtol=1e-3, atol=1e-3):
            fail(f"{cfg.name} card vs CPU {what} logits differ: max|diff| {err:.3e}")
    print(f"model card vs CPU [{cfg.name} float, L={MOE_CHECK_LAYERS}, full width, "
          f"f32]: routing equal over {len(routes['cpu'])} MoE calls ({n_tok} "
          f"token rows; expert ids and dispatch positions; smallest k-th to "
          f"(k+1)-th probability gap {gaps:.3e}); extend max|diff| {errs[0]:.2e}, "
          f"decode {errs[1]:.2e} (rtol=atol=1e-3) OK; "
          f"{time.perf_counter() - t0:.1f}s", flush=True)


def phase_serve_recurrent(arch: str, phase: str):
    """Phases 4h and 4i: ``arch`` (mamba2-370m, recurrentgemma-2b) at its
    published width and depth under each compute path, as phase 4b, with
    no page pool and the slot reset among the captured entry points; for
    recurrentgemma-2b then the window-wrapping request (:func:`wrap_run`).
    Returns (params, launch counts)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    sp, launches = phase_serve_paths(cfg, phase)
    if cfg.window:
        t0 = time.perf_counter()
        for k, v in wrap_run(cfg, sp).items():
            if k in launches:
                launches[k] += v
        print(f"phase {phase} ({arch} window wrap): {time.perf_counter() - t0:.1f}s",
              flush=True)
    return sp, launches


def wrap_run(cfg, sp):
    """One request whose WRAP_PROMPT-token prompt is longer than the
    attention window, beside a 40-token one, on WRAP_MAX_LEN-token slots
    (rings of min(WRAP_MAX_LEN, window) rows), 16 greedy tokens each, float
    path, cold and then warm: the same counter checks as phase 3 and the
    warm tokens equal to the cold ones. Returns the cold counts."""
    import numpy as np
    import torch

    from repro_torch.configs import build_model
    from repro_torch.nn import module as mod
    from repro_torch.nn.context import SERVE, ModelContext
    from repro_torch.serve.engine import TRACE_COUNTS, BatchedEngine, ServeConfig

    s_model = build_model(cfg, ModelContext(policy=cfg.tbn, mode=SERVE,
                                            compute_dtype=torch.bfloat16,
                                            device="cuda"))
    label = f"{cfg.name} float, {WRAP_PROMPT}-token prompt"
    if WRAP_PROMPT <= cfg.window or WRAP_MAX_LEN < WRAP_PROMPT + 16:
        fail(f"{label}: the prompt must pass the {cfg.window}-token window "
             f"and fit a {WRAP_MAX_LEN}-token slot")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in (WRAP_PROMPT, 40)]

    def engine():
        eng = BatchedEngine(s_model, sp, ServeConfig(
            n_slots=N_SLOTS, max_len=WRAP_MAX_LEN, chunk_tokens=CHUNK,
            page_tokens=16, compute_path="float"))
        rings = [v.shape for c in eng.caches for p, v in mod.walk(c)
                 if p[-1] == "k"]
        if not rings or any(r[-3] != min(WRAP_MAX_LEN, cfg.window) for r in rings):
            fail(f"{label}: ring caches {rings}, expected {cfg.window} rows")
        return eng

    cold = drive(engine(), cfg, prompts, 16)
    release()
    st, counts = cold["st"], cold["counts"]
    need = (layer_calls(cfg) + 1) * st["decode_ticks"] + st["extend_ticks"]
    if (counts["B1"] != need or counts["B2"] < st["extend_ticks"]
            or any(counts[k] for k in ("B3", "B4", "B5", "B6"))):
        fail(f"{label}: launch counters {counts}; need B1 = {need}, B2 >= "
             f"{st['extend_ticks']}, the others 0")
    eng = engine()
    timings = eng.warmup()
    traces = TRACE_COUNTS.copy()
    warm = drive(eng, cfg, prompts, 16)
    wst = warm["st"]
    del eng
    release()
    if any(warm["counts"].values()) or TRACE_COUNTS != traces:
        fail(f"{label} warm: the drain launched {warm['counts']} or moved "
             f"TRACE_COUNTS: a tick did not replay its graph")
    if (warm["tokens"], warm["steps"]) != (cold["tokens"], cold["steps"]):
        fail(f"{label} warm: greedy tokens differ from the cold run's")
    print(f"serve [{label}, window {cfg.window}, slots of {WRAP_MAX_LEN}]: the "
          f"ring wraps; cold -> warm: {st['extend_ticks']} extend ticks "
          f"{st['extend_ms_mean']:.2f} -> {wst['extend_ms_mean']:.2f}ms, decode "
          f"tick {st['decode_ms_mean']:.2f} -> {wst['decode_ms_mean']:.2f}ms, "
          f"TTFT mean {cold['ttft']:.1f} -> {warm['ttft']:.1f}ms, ITL mean "
          f"{cold['itl']:.2f} -> {warm['itl']:.2f}ms; capture "
          + ", ".join(f"{k} {v:.3f}s" for k, v in timings.items())
          + f"; greedy tokens equal warm and cold; launches "
          + " ".join(f"{k}={v}" for k, v in counts.items()), flush=True)
    return counts


def recurrent_layers(cfg, sp, dev: str, prompts):
    """``cfg`` cut to SSM_CHECK_LAYERS layers (its stacked segments sliced,
    its tails kept), f32, on ``dev``: two slots extend ``prompts`` in
    SSM_CHECK_CHUNK-column chunks, then three greedy decode steps. Returns
    (the logits of every call, the decode steps' greedy tokens)."""
    import torch

    from repro_torch.configs import build_model
    from repro_torch.nn import module as mod
    from repro_torch.nn.context import SERVE, ModelContext

    cfg2 = dataclasses.replace(cfg, n_layers=SSM_CHECK_LAYERS[cfg.name])
    model = build_model(cfg2, ModelContext(policy=cfg.tbn, mode=SERVE,
                                           compute_dtype=torch.float32,
                                           device=dev))
    params = dict(sp)
    for i, seg in enumerate(model.segments):
        leaves = sp[f"seg{i}"]
        params[f"seg{i}"] = (mod.map_tree(lambda v, n=seg.n: v[:n], leaves)
                             if seg.scanned else leaves)
    params = mod.map_tree(lambda v: v.to(dev), params)
    caches = model.init_caches(2, WRAP_MAX_LEN, torch.float32)
    lengths = torch.zeros(2, dtype=torch.int32, device=dev)
    logits, toks = [], []
    c = SSM_CHECK_CHUNK
    with torch.no_grad():
        for at in range(0, max(len(p) for p in prompts), c):
            block = torch.zeros((2, c), dtype=torch.long)
            n_new = torch.zeros(2, dtype=torch.int32)
            for s, p in enumerate(prompts):
                seg = torch.from_numpy(p[at:at + c])
                block[s, :len(seg)] = seg
                n_new[s] = len(seg)
            lg, caches, lengths = model.extend(params, block.to(dev), caches,
                                               lengths, n_new.to(dev))
            logits.append(lg.cpu()[n_new > 0])
        tok = lg.argmax(-1)[:, None]
        for _ in range(3):
            lg, caches, lengths = model.decode_step(params, tok, caches, lengths)
            logits.append(lg.cpu())
            tok = lg.argmax(-1)[:, None]
            toks.append(tok.cpu())
    return logits, torch.cat(toks, 1)


def phase_recurrent_card_vs_cpu(cfg, sp, lens):
    """Phase 4j: ``cfg`` at full width, f32, card (kernels) against CPU
    (plain versions): logits of every extend and decode call at rtol = atol
    = 1e-4, the greedy decode tokens equal."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in lens]
    (lg_card, tok_card), (lg_cpu, tok_cpu) = (
        recurrent_layers(cfg, sp, dev, prompts) for dev in ("cuda", "cpu"))
    errs = [float((a - b).abs().max()) for a, b in zip(lg_card, lg_cpu)]
    for i, (a, b) in enumerate(zip(lg_card, lg_cpu)):
        if not torch.isfinite(a).all() or not torch.allclose(a, b, rtol=1e-4, atol=1e-4):
            fail(f"{cfg.name} card vs CPU: call {i} logits differ, max|diff| "
                 f"{errs[i]:.3e}")
    if not torch.equal(tok_card, tok_cpu):
        fail(f"{cfg.name} card vs CPU: greedy tokens {tok_card.tolist()} vs "
             f"{tok_cpu.tolist()}")
    print(f"model card vs CPU [{cfg.name} float, L={SSM_CHECK_LAYERS[cfg.name]}, "
          f"full width, f32]: prompts {list(lens)} in {SSM_CHECK_CHUNK}-token "
          f"chunks, then 3 decode steps: logits max|diff| {max(errs):.2e} over "
          f"{len(errs)} calls (rtol=atol=1e-4), greedy tokens {tok_card.tolist()} "
          f"equal; {time.perf_counter() - t0:.1f}s", flush=True)


def b5_per_step(n_layers: int):
    """{shape name: B5 calls per train step}: each tiled Dense runs once in
    the forward and once more in the remat recompute of its block's
    backward; the LM head is not under remat."""
    return {name: (1 if name == "head" else 2 * per * n_layers)
            for name, _, _, per in B5_SHAPES}


def phase_b5(card: str):
    """Phase 2, B5: kernel vs plain at the full-width shapes. Returns
    {(shape, source): measurements}."""
    import torch

    from repro_torch.core.tiling import plan_tiling
    from repro_torch.kernels import ops
    from repro_torch.kernels.tile_construct import tile_construct_plain

    bw = peaks(card)[0]
    kernel = kernels()["B5"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    results = {}
    for name, p, q, _ in B5_SHAPES:
        w = torch.randn((p, q), generator=gen, device="cuda")
        for source in ("W", "A"):
            a = torch.randn((p, q), generator=gen, device="cuda") if source == "A" else None
            before = kernel.launches
            got = kernel(w, a)
            torch.cuda.synchronize()
            if kernel.launches != before + 1:
                fail("tile_construct_kernel did not count its launch")
            want = tile_construct_plain(w, a)
            if got[0].dtype != torch.int32 or not torch.equal(got[0], want[0]):
                n_bad = int((got[0] != want[0]).sum())
                fail(f"B5 {name} p={p} q={q} alpha from {source}: {n_bad} packed "
                     f"words differ from the plain version")
            err = float((got[1] - want[1]).abs().max())
            if not torch.allclose(got[1], want[1], rtol=1e-5, atol=0):
                fail(f"B5 {name} alpha from {source}: max|err| {err:.3e} over rtol 1e-5")
            nbytes = p * q * 4 * (2 if a is not None else 1) + q // 8 + p * 4
            res = dict(err=err, ms=time_ms(lambda: kernel(w, a)),
                       plain_ms=time_ms(lambda: tile_construct_plain(w, a)),
                       bound_ms=1e3 * nbytes / bw)
            results[(name, source)] = res
            print(f"B5 {name:12s} p={p} q={q:9d} alpha from {source}: words equal, "
                  f"alpha max|err|={err:.2e} kernel {res['ms']:.4f}ms plain "
                  f"{res['plain_ms']:.4f}ms bound {res['bound_ms']:.4f}ms "
                  f"({nbytes / 1e6 / res['ms']:.0f} GB/s)", flush=True)
            del a
        del w
    for source in ("W", "A"):        # q = 500: padded to 512 by ops.tile_construct
        spec = plan_tiling((40, 50), p=4, min_size=1, alpha_source=source)
        w = torch.randn((40, 50), generator=gen, device="cuda")
        a = torch.randn((40, 50), generator=gen, device="cuda")
        got = ops.tile_construct(w, spec, a=a)
        want = ops.tile_construct(w.cpu(), spec, a=a.cpu())
        if not torch.equal(got[0].cpu(), want[0]) or not torch.allclose(
                got[1].cpu(), want[1], rtol=1e-5, atol=0):
            fail(f"B5 q=500 (padded) alpha from {source}: card differs from CPU")
    print("B5 q=500 (padded to 512) alpha from W and A: card == CPU", flush=True)
    torch.cuda.empty_cache()
    return results


def profile_train_step(step_fn, state, batch, label: str):
    """One traced train step: device busy time (sum of kernel durations;
    one stream) against its wall time, the top kernels and B5's share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, met = step_fn(state, batch)
        float(met["loss"])
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events, by_name = device_time_by_name(prof)
    if not events:
        print(f"profile [{label}]: the profiler recorded no device events "
              f"(device time not measured)")
        return state, None
    busy = sum(t for t, _ in by_name.values())
    b5 = sum(t for k, (t, _) in by_name.items()
             if "construct_kernel" in k or "alpha_kernel" in k)
    b2 = sum(t for k, (t, _) in by_name.items()
             if "matmul_wgmma_kernel" in k or "matmul_f32_kernel" in k
             or "sum_splits_kernel" in k)
    print(f"profile [{label}]: step device busy {busy:.1f} ms of {wall_ms:.1f} ms "
          f"wall (profiled) -> device idle share {1 - busy / wall_ms:.3f}; "
          f"{len(events)} device ops; B5 {b5:.2f} ms ({b5 / busy:.3f} of busy), "
          f"B2 {b2:.2f} ms ({b2 / busy:.3f})", flush=True)
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"  {t:9.3f} ms {n:6d}x  {name[:90]}")
    return state, dict(busy_ms=busy, wall_ms=wall_ms, b5_ms=b5, b2_ms=b2)


def train_run(cfg, ctx, ckpt_dir: str, label: str):
    """One RecoveryManager run to TRAIN_STEPS through the CLI's wiring.
    Every counter is 0 just before it and read just after it. Returns
    (Training, final state, {step: (loss, grad_norm)}, counts, step ends)."""
    import torch

    from repro_torch.launch.train import build_training

    tr = build_training(cfg, ctx, seed=0, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                        lr=3e-4, warmup=2, total_steps=8, grad_accum=1,
                        ckpt_dir=ckpt_dir, ckpt_every=RESUME_FROM)
    log, ends = {}, {}

    def hooks(step, state, metrics):
        log[step] = (float(metrics["loss"]), float(metrics["grad_norm"]))
        ends[step] = time.perf_counter()

    zero_counters()
    final = tr.recovery.run(tr.step_fn, TRAIN_STEPS, hooks=hooks)
    torch.cuda.synchronize()
    counts = read_counters()
    if tr.recovery.restarts != 0:
        fail(f"train [{label}]: {tr.recovery.restarts} restarts (a restart can "
             f"hide a kernel fault)")
    if not all(math.isfinite(x) for v in log.values() for x in v):
        fail(f"train [{label}]: a loss or grad norm is not finite: {log}")
    return tr, final, log, counts, ends


def phase_train_fused(cfg):
    """Phase 5: fused training at full width, TRAIN_LAYERS layers, with a
    checkpoint resume. Returns the measurements for the summary."""
    import torch

    from repro_torch.data.synthetic import lm_batch
    from repro_torch.nn.context import TRAIN, ModelContext

    cfg4 = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS)
    ctx = ModelContext(policy=cfg.tbn, mode=TRAIN, compute_dtype=torch.bfloat16,
                       device="cuda", fused_train=True)
    L = TRAIN_LAYERS
    # per forward pass one launch per tiled Dense (7 L + 1: q, k, v, o,
    # gate, up, down per layer, and the LM head); the backward's remat
    # recomputes each block's forward once more (7 L); the head is not
    # under remat, and tbn_dense_train's own backward runs no kernel
    per_step = 2 * 7 * L + 1
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        t0 = time.perf_counter()
        tr, final, log1, counts1, ends = train_run(cfg4, ctx, tmp, "run 1")
        t_run1 = time.perf_counter() - t0
        want = TRAIN_STEPS * per_step
        if (counts1["B5"] != want or counts1["B2"] != want
                or any(counts1[k] for k in ("B1", "B3", "B4", "B6"))):
            fail(f"train [run 1]: launch counters {counts1}; need B5 = B2 = "
                 f"{TRAIN_STEPS} * (14 L + 1) = {want}, B1 = B3 = B4 = B6 = 0")
        print(f"train [fused, L={L}, full width, bf16, B*S={TRAIN_BATCH}x{TRAIN_SEQ}] "
              f"run 1: {TRAIN_STEPS} steps in {t_run1:.1f}s (with set-up and 2 "
              f"checkpoints); losses " + " ".join(f"{v[0]:.4f}" for v in log1.values())
              + " | grad norms " + " ".join(f"{v[1]:.3f}" for v in log1.values())
              + " | launches " + " ".join(f"{k}={v}" for k, v in counts1.items()),
              flush=True)

        # steady step time, off the recovery loop (counters already read)
        state = final
        times = []
        for i in range(3):
            batch = lm_batch(0, TRAIN_STEPS + i, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab)
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, met = tr.step_fn(state, batch)
            float(met["loss"])
            times.append(time.perf_counter() - t)
        step_ms = 1e3 * statistics.median(times)
        tok_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        print(f"train [fused]: step wall {step_ms:.1f} ms (median of "
              + ", ".join(f"{1e3 * t:.1f}" for t in times) + f" ms), {tok_s:.0f} "
              f"tokens/s, peak device memory {peak_gb:.1f} GB", flush=True)
        batch = lm_batch(0, TRAIN_STEPS + 3, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab)
        state, prof = profile_train_step(tr.step_fn, state, batch, "fused train step")
        del state, final, tr
        gc.collect()
        torch.cuda.empty_cache()

        shutil.rmtree(Path(tmp) / f"step_{TRAIN_STEPS:08d}")
        tr2, final2, log2, counts2, _ = train_run(cfg4, ctx, tmp, "resume")
        want2 = (TRAIN_STEPS - RESUME_FROM) * per_step
        if sorted(log2) != list(range(RESUME_FROM + 1, TRAIN_STEPS + 1)):
            fail(f"train [resume]: ran steps {sorted(log2)}, expected "
                 f"{RESUME_FROM + 1}..{TRAIN_STEPS} from the step-{RESUME_FROM} checkpoint")
        if (counts2["B5"] != want2 or counts2["B2"] != want2
                or any(counts2[k] for k in ("B1", "B3", "B4", "B6"))):
            fail(f"train [resume]: launch counters {counts2}; need B5 = B2 = {want2}")
        worst = 0.0
        for s_, (loss2, _) in log2.items():
            rel = abs(loss2 - log1[s_][0]) / abs(log1[s_][0])
            worst = max(worst, rel)
            if rel > REPLAY_RTOL:
                fail(f"train [resume]: step {s_} loss {loss2} vs {log1[s_][0]} in run 1")
        print(f"train [resume from step {RESUME_FROM}]: steps {sorted(log2)} losses "
              + " ".join(f"{log2[k][0]:.4f}" for k in sorted(log2))
              + f", max rel diff to run 1 {worst:.2e} (rtol {REPLAY_RTOL}); restarts "
              f"0 and 0; launches " + " ".join(f"{k}={v}" for k, v in counts2.items()),
              flush=True)
        del final2, tr2
        gc.collect()
        torch.cuda.empty_cache()
    return dict(launches=counts1["B5"], step_ms=step_ms, tok_s=tok_s, prof=prof,
                per_step=per_step)


def phase_train_cli(arch: str):
    """Phase 6: the training CLI, unfused default path, on the card."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
             "--reduced", "--steps", "3", "--ckpt-dir", tmp],
            capture_output=True, text=True, timeout=600, env=env, cwd=str(ROOT))
        dt = time.perf_counter() - t0
    if out.returncode != 0 or "done: 3 steps" not in out.stdout:
        fail(f"train CLI ({arch}) exit {out.returncode}:\n{out.stdout[-2000:]}\n"
             f"{out.stderr[-3000:]}")
    lines = out.stdout.strip().splitlines()
    print(f"train CLI (--arch {arch} --reduced --steps 3, card, unfused) exit 0 "
          f"in {dt:.1f}s: {lines[0]} | {lines[-2]}", flush=True)


def phase_train_card_vs_cpu(cfg):
    """Phase 7: full width, 2 layers, f32, fused: card against CPU."""
    import torch

    from repro_torch.configs import build_model
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.kernels import ops
    from repro_torch.nn import module as mod
    from repro_torch.nn.context import TRAIN, ModelContext

    cfg2 = dataclasses.replace(cfg, n_layers=2)
    models = {dev: build_model(cfg2, ModelContext(
        policy=cfg.tbn, mode=TRAIN, compute_dtype=torch.float32, device=dev,
        fused_train=True)) for dev in ("cuda", "cpu")}
    params = {"cuda": models["cuda"].init(0)}
    params["cpu"] = mod.map_tree(lambda v: v.cpu(), params["cuda"])
    n_words = 0
    for path, w in mod.walk(params["cuda"]):
        if path[-1] != "w":
            continue
        spec = cfg.tbn.spec_for(tuple(w.shape[-2:]),
                                kind="head" if path[0] == "head" else "dense")
        w_cpu = mod.get_path(params["cpu"], path)
        for j in range(w.shape[0] if w.ndim == 3 else 1):
            wl, wl_cpu = (w[j], w_cpu[j]) if w.ndim == 3 else (w, w_cpu)
            got, want = ops.tile_construct(wl, spec), ops.tile_construct(wl_cpu, spec)
            if not torch.equal(got[0].cpu(), want[0]):
                fail(f"train card vs CPU: B5 words of {'/'.join(path)}[{j}] differ")
            n_words += got[0].numel()
    batch = lm_batch(0, 0, 1, 64, cfg.vocab)
    out = {}
    for dev in ("cuda", "cpu"):
        paths, leaves = zip(*mod.walk(params[dev]))
        for v in leaves:
            v.requires_grad_(True)
        t0 = time.perf_counter()
        loss, _ = models[dev].train_forward(params[dev], batch)
        grads = torch.autograd.grad(loss, leaves)
        out[dev] = (float(loss.detach()), [g.cpu() for g in grads])
        print(f"train card vs CPU: {dev} forward+backward {time.perf_counter() - t0:.1f}s",
              flush=True)
        del grads, loss
    rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    if not rel <= 1e-4:
        fail(f"train card vs CPU: loss {out['cuda'][0]} vs {out['cpu'][0]}")
    worst = 0.0
    for path, g, g_cpu in zip(paths, out["cuda"][1], out["cpu"][1]):
        scale = float(g_cpu.abs().max())
        if not torch.isfinite(g).all() or not torch.allclose(
                g, g_cpu, rtol=1e-3, atol=1e-3 * scale):
            fail(f"train card vs CPU: gradient {'/'.join(path)} max|diff| "
                 f"{float((g - g_cpu).abs().max()):.3e} (max|g| {scale:.3e})")
        worst = max(worst, float((g - g_cpu).abs().max()) / max(scale, 1e-30))
    print(f"train card vs CPU (fused, L=2, full width, f32, 1x64): B5 words of all "
          f"tiled layers equal ({n_words} words), loss rel diff {rel:.2e} (rtol 1e-4), "
          f"{len(paths)} gradient leaves max|diff|/max|g| {worst:.2e} (rtol 1e-3) OK",
          flush=True)
    del params, models, out
    gc.collect()
    torch.cuda.empty_cache()


def conv_operands(n: int, h: int, c: int, r: int, stride: int, dtype, gen):
    """Padded NHWC input and a random conv-layout tile for one ResNet-34
    3x3 SAME conv, as ``ops.tiled_conv_infer`` hands them to B6."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ops import resolve_conv_padding

    (oh, ow), ((lo, hi), _) = resolve_conv_padding((h, h), (3, 3),
                                                   (stride, stride), "SAME")
    x = torch.randn((n, h, h, c), generator=gen, device="cuda").to(dtype)
    x = F.pad(x, (0, 0, lo, hi, lo, hi))
    packed = torch.randint(0, 2**32, (9, r, c // 32), generator=gen,
                           device="cuda", dtype=torch.int64).to(torch.int32)
    return x, packed, dict(kernel=(3, 3), stride=(stride, stride), out_hw=(oh, ow))


def check_conv(x, packed, kw, bw, peak):
    """B6 once against its plain version on the same card inputs (tolerance
    and counter), then timed beside the plain version, the library
    yardstick and the bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.packing import unpack_conv_tile
    from repro_torch.kernels.tiled_conv import tiled_conv_plain

    kernel = kernels()["B6"]
    before = kernel.launches
    got = kernel(x, packed, **kw)
    torch.cuda.synchronize()
    if kernel.launches != before + 1:
        fail("tiled_conv_unique did not count its launch")
    want = tiled_conv_plain(x, packed, **kw)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=RTOL, atol=RTOL * scale):
        fail(f"B6 x={tuple(x.shape)} r={packed.shape[1]} {x.dtype}: max|err| "
             f"{err:.3e} over tolerance (max|u| {scale:.3e})")
    n, _, _, c = x.shape
    (oh, ow), r = kw["out_hw"], packed.shape[1]
    bank = unpack_conv_tile(packed, r, c, 3, 3, dtype=x.dtype)
    x_nchw = x.permute(0, 3, 1, 2)          # channels-last view: cuDNN NHWC
    m = n * oh * ow
    nbytes = x.numel() * x.element_size() + packed.numel() * 4 + m * r * 4
    flops = 2.0 * m * 9 * c * r
    t_bytes, t_ops = 1e3 * nbytes / bw, 1e3 * flops / peak
    res = dict(err=err, scale=scale, flops=flops,
               ms=time_ms(lambda: kernel(x, packed, **kw)),
               plain_ms=time_ms(lambda: tiled_conv_plain(x, packed, **kw)),
               library_ms=time_ms(lambda: F.conv2d(x_nchw, bank, stride=kw["stride"])),
               bound_ms=max(t_bytes, t_ops), bytes_ms=t_bytes, ops_ms=t_ops)
    if x.dtype == torch.bfloat16:
        from repro_torch.kernels.tiled_conv import (
            CONV_BODIES,
            plan_conv,
            tiled_conv_body,
        )
        from repro_torch.kernels.tiled_matmul import _sm_count, plan_cost

        sms = _sm_count(x.device.index)
        res.update(survey_bodies(
            lambda body: tiled_conv_body(x, packed, body, **kw), want, CONV_BODIES,
            lambda body: plan_conv(m, r, (3, 3), c // 32, sms, body=body),
            lambda plan: plan_cost(plan, m, r, sms),
            f"B6 x={tuple(x.shape)} r={r}"))
    return res


def conv_infer_cases():
    """(label, (c_out, c_in, kh, kw, p), stride, padding, alpha_mode, (H, W))
    of the ``tiled_conv_infer`` card-vs-CPU checks."""
    return (("C=48", (64, 48, 3, 3, 2), (1, 1), "SAME", "tile", (14, 14)),
            ("1x1 s2 256->512 p=8", (512, 256, 1, 1, 8), (2, 2), "SAME", "tile",
             (14, 14)),
            ("k(5,3) s(1,2) VALID", (64, 32, 5, 3, 2), (1, 2), "VALID", "tile",
             (12, 11)),
            ("SAME_LOWER s2", (64, 32, 3, 3, 2), (2, 2), "SAME_LOWER", "tile",
             (14, 14)),
            ("pads [(2,1),(0,2)]", (64, 32, 3, 3, 2), (1, 1), [(2, 1), (0, 2)],
             "tile", (7, 7)),
            ("alpha layer s2", (128, 64, 3, 3, 2), (2, 2), "SAME", "layer",
             (28, 28)),
            ("alpha tile s2", (128, 64, 3, 3, 2), (2, 2), "SAME", "tile",
             (28, 28)))


def phase_conv(card: str):
    """Phase 8: B6 vs plain at the ResNet-34 shapes, then the wrapper's
    padding and alpha cases card vs CPU. Returns {(shape, N, dtype):
    measurements}."""
    import torch

    from repro_torch.core.packing import pack_conv_tile
    from repro_torch.core.tiling import plan_tiling
    from repro_torch.kernels import ops

    bw, bf16_peak, f32_peak, _ = peaks(card)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    results = {}
    for name, h, c, r, stride, _ in CONV_SHAPES:
        for n in CONV_NS:
            for dtype, peak in ((torch.bfloat16, bf16_peak), (torch.float32, f32_peak)):
                x, packed, kw = conv_operands(n, h, c, r, stride, dtype, gen)
                res = check_conv(x, packed, kw, bw, peak)
                dname = str(dtype).split(".")[-1]
                results[(name, n, dname)] = res
                print(f"B6 {name:22s} N={n:2d} r={r} {dname:8s} max|err|="
                      f"{res['err']:.2e} (max|u|={res['scale']:.1f}) kernel "
                      f"{res['ms']:.4f}ms plain {res['plain_ms']:.4f}ms library "
                      f"{res['library_ms']:.4f}ms bound {res['bound_ms']:.4f}ms "
                      f"({'ops' if res['ops_ms'] >= res['bytes_ms'] else 'bytes'}) "
                      f"| {tflops(res)}", flush=True)
                del x, packed
    for n in CONV_NS:
        for dname in ("bfloat16", "float32"):
            tot = conv_forward_totals(results, n, dname)
            print(f"B6 per ResNet-34 forward, N={n}, {dname} (18 calls): kernel "
                  f"{tot['ms']:.3f}ms plain {tot['plain_ms']:.3f}ms library "
                  f"{tot['library_ms']:.3f}ms bound {tot['bound_ms']:.3f}ms",
                  flush=True)
    worst = 0.0
    for label, (c_out, c_in, kh, kw, p), stride, padding, mode, hw in conv_infer_cases():
        spec = plan_tiling((c_out, c_in, kh, kw), p=p, min_size=0, alpha_mode=mode)
        x = torch.randn((2, *hw, c_in), generator=gen, device="cuda")
        t = torch.randn((spec.q,), generator=gen, device="cuda")
        packed = pack_conv_tile(t, c_out // p, c_in, kh, kw)
        alpha = torch.rand((spec.n_alpha,), generator=gen, device="cuda") + 0.1
        before = kernels()["B6"].launches
        got = ops.tiled_conv_infer(x, packed, alpha, spec, stride=stride,
                                   padding=padding).cpu()
        if kernels()["B6"].launches != before + 1:
            fail(f"tiled_conv_infer [{label}] did not launch B6")
        want = ops.tiled_conv_infer(x.cpu(), packed.cpu(), alpha.cpu(), spec,
                                    stride=stride, padding=padding)
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        worst = max(worst, err / scale)
        if got.shape != want.shape or not torch.allclose(got, want, rtol=RTOL,
                                                         atol=RTOL * scale):
            fail(f"tiled_conv_infer [{label}] card vs CPU: max|err| {err:.3e} "
                 f"(max|y| {scale:.3e})")
    print(f"tiled_conv_infer card vs CPU (f32; C=48, 1x1 s2 p=8, k(5,3) VALID, "
          f"SAME_LOWER, explicit pads, alpha layer/tile): max|err|/max|y| "
          f"{worst:.2e} (rtol {RTOL}) OK", flush=True)
    torch.cuda.empty_cache()
    return results


def conv_forward_totals(results, n: int, dtype: str):
    """Sum the per-shape B6 measurements over the 18 calls of a forward."""
    return {key: sum(calls * results[(name, n, dtype)][key]
                     for name, _, _, _, _, calls in CONV_SHAPES)
            for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms",
                        "ops_ms")}


def resnet34_models(dtype, devices=("cuda",)):
    """(TRAIN model, {device: SERVE model}, policy, ledger report) of
    ResNet-34 ImageNet under Table 1's policy."""
    from repro_torch.core.policy import tbn_policy
    from repro_torch.models.paper import build_paper_model
    from repro_torch.nn.context import SERVE, TRAIN, ModelContext

    pol = tbn_policy(p=2, min_size=150_000, alpha_source="A", alpha_mode="tile")
    kw = dict(imagenet=True, classes=1000)
    tctx = ModelContext(policy=pol, mode=TRAIN, device="cuda")
    tm = build_paper_model("resnet34", tctx, **kw)
    sms = {dev: build_paper_model("resnet34", ModelContext(
        policy=pol, mode=SERVE, compute_dtype=dtype, device=dev), **kw)
        for dev in devices}
    return tm, sms, pol, tctx.ledger.report()


def r34_forwards(model, sp, x, n_fwd: int):
    """``n_fwd`` synchronized forwards; counters zeroed just before and read
    just after. Returns (logits of the last, [seconds], counts)."""
    import torch

    zero_counters()
    times = []
    with torch.no_grad():
        for _ in range(n_fwd):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = model(sp, x)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    return y, times, read_counters()


def phase_resnet34():
    """Phase 9: ResNet-34 ImageNet at full width through the entry points.
    Returns (exported SERVE params, measurements)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.nn import module as mod
    from repro_torch.serve.weights import (
        export_serving_params,
        serving_bytes,
        tile_serving_bytes,
    )

    t0 = time.perf_counter()
    tm, sms, pol, rep = resnet34_models(torch.bfloat16)
    sm = sms["cuda"]
    got = (rep.universe_params, round(rep.mbit(), 3), round(rep.bits_per_param(), 4))
    if got != R34_LEDGER:
        fail(f"ResNet-34 ledger {got}, expected {R34_LEDGER}")
    tp = tm.init(0)
    sp = export_serving_params(tm.specs(), sm.specs(), tp, pol)
    master_b = serving_bytes(tp)
    del tp
    torch.cuda.synchronize()
    n_b6 = sum(1 for path, _ in mod.walk(sp) if path[-1] == "tile_conv")
    if n_b6 != 18:
        fail(f"ResNet-34 SERVE tree has {n_b6} tiled convs, expected 18")
    print(f"resnet34-imagenet TBN p=2 lambda=150k: {rep.universe_params:,} params, "
          f"{rep.mbit():.3f} Mbit, {rep.bits_per_param():.4f} bits/param; masters "
          f"(W and A) {master_b / 1e6:.1f} MB -> shipped {serving_bytes(sp) / 1e6:.3f} "
          f"MB (tile words {tile_serving_bytes(sp) / 1e6:.3f} MB), 18 tiled convs, "
          f"exported in {time.perf_counter() - t0:.1f}s", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    x = torch.randn((R34_BATCH, 224, 224, 3), generator=gen, device="cuda")
    r34_forwards(sm, sp, x, 1)                              # warm-up
    y, times, counts = r34_forwards(sm, sp, x, R34_TIMED)
    need = dict(B1=0, B2=R34_TIMED, B3=0, B4=0, B5=0, B6=18 * R34_TIMED)
    if counts != need:
        fail(f"resnet34 N={R34_BATCH}: launch counters {counts}, need {need}")
    if y.shape != (R34_BATCH, 1000) or not torch.isfinite(y).all():
        fail(f"resnet34 N={R34_BATCH}: logits {tuple(y.shape)} not finite")
    fwd_ms = 1e3 * statistics.median(times)
    x1 = x[:1].contiguous()
    r34_forwards(sm, sp, x1, 1)
    y1, times1, counts1 = r34_forwards(sm, sp, x1, R34_TIMED)
    need1 = dict(need, B1=R34_TIMED, B2=0)
    if counts1 != need1 or y1.shape != (1, 1000) or not torch.isfinite(y1).all():
        fail(f"resnet34 N=1: launch counters {counts1} (need {need1}) or "
             f"logits not finite")
    lat_ms = 1e3 * statistics.median(times1)
    print(f"serve resnet34-imagenet bf16 N={R34_BATCH}: forward {fwd_ms:.2f} ms "
          f"(median of {R34_TIMED}: " + ", ".join(f"{1e3 * t:.2f}" for t in times)
          + f"), {R34_BATCH / (fwd_ms / 1e3):.0f} images/s | N=1 latency "
          f"{lat_ms:.2f} ms (median of {R34_TIMED}) | launches N={R34_BATCH} "
          + " ".join(f"{k}={v}" for k, v in counts.items()) + " | N=1 "
          + " ".join(f"{k}={v}" for k, v in counts1.items()), flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            sm(sp, x)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events, by_name = device_time_by_name(prof)
    prof_res = None
    if not events:
        print("profile [resnet34]: the profiler recorded no device events "
              "(device time not measured)")
    else:
        busy = sum(t for t, _ in by_name.values())
        # N = 64 fills the card without split K, so B6 is its main kernel
        b6 = sum(t for k, (t, _) in by_name.items() if "conv_wgmma_kernel" in k)
        print(f"profile [resnet34 N={R34_BATCH} forward]: device busy {busy:.2f} ms "
              f"of {wall_ms:.2f} ms wall (profiled) -> device idle share "
              f"{1 - busy / wall_ms:.3f}; {len(events)} device ops; B6 {b6:.2f} ms "
              f"({b6 / busy:.3f} of busy)", flush=True)
        for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
            print(f"  {t:8.3f} ms {n:5d}x  {name[:90]}")
        prof_res = dict(busy_ms=busy, wall_ms=wall_ms, b6_ms=b6)
    del x, y
    torch.cuda.empty_cache()
    return sp, dict(launches=counts["B6"], fwd_ms=fwd_ms, lat_ms=lat_ms,
                    prof=prof_res)


def phase_resnet34_card_vs_cpu(sp):
    """Phase 10: the same export in f32, N = 2 at 224 x 224, card vs CPU."""
    import torch

    from repro_torch.nn import module as mod

    _, sms, _, _ = resnet34_models(torch.float32, devices=("cuda", "cpu"))
    gen = torch.Generator()
    gen.manual_seed(2)
    x = torch.randn((2, 224, 224, 3), generator=gen)
    sp_cpu = mod.map_tree(lambda v: v.cpu(), sp)
    y_card, _, counts = r34_forwards(sms["cuda"], sp, x.cuda(), 1)
    if counts["B6"] != 18 or counts["B1"] != 1 or counts["B2"]:
        fail(f"resnet34 card vs CPU: launch counters {counts}")
    t0 = time.perf_counter()
    with torch.no_grad():
        y_cpu = sms["cpu"](sp_cpu, x)
    dt = time.perf_counter() - t0
    y_card = y_card.cpu()
    err = float((y_card - y_cpu).abs().max())
    if not torch.isfinite(y_card).all() or not torch.allclose(
            y_card, y_cpu, rtol=1e-3, atol=1e-3):
        fail(f"resnet34 card vs CPU logits differ: max|diff| {err:.3e} "
             f"(max|logit| {float(y_cpu.abs().max()):.3e})")
    print(f"resnet34 card vs CPU (full width, f32, N=2, 224x224): logits max|diff| "
          f"{err:.2e} (max|logit| {float(y_cpu.abs().max()):.2f}, rtol=atol=1e-3) "
          f"OK; CPU forward {dt:.1f}s", flush=True)


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
    check_tensor_core_sass(_build)

    results = phase_kernels(card)
    phase_family_kernels(card, results)
    b5 = phase_b5(card)
    cfg = get_config("granite-8b")
    sp, launches = phase_serve(cfg)
    phase_card_vs_cpu(cfg, sp)
    del sp
    qwen = get_config(QWEN)
    sp, counts = phase_serve_paths(
        dataclasses.replace(qwen, n_layers=QWEN_SERVE_LAYERS), "4b")
    phase_qwen_card_vs_cpu(qwen, sp)
    del sp
    for arch in ("minitron-8b", "starcoder2-7b"):
        counts = {k: counts[k] + v for k, v in phase_serve_family(
            arch, n_layers=FAMILY_SERVE_LAYERS).items() if k in counts}
    moe = get_config(MOE)
    sp, moe_counts = phase_serve_paths(moe, "4e")
    phase_moe_card_vs_cpu(moe, sp)
    del sp
    release()
    moe_counts = {k: moe_counts[k] + v for k, v in phase_serve_family(
        MOONSHOT, "4f", profile_ticks=1).items() if k in moe_counts}
    rec_counts = dict.fromkeys(moe_counts, 0)
    for arch, phase, lens in ((MAMBA, "4h", (600, 200)),
                              (RECGEMMA, "4i", (WRAP_PROMPT, 300))):
        sp, part = phase_serve_recurrent(arch, phase)
        rec_counts = {k: rec_counts[k] + part[k] for k in rec_counts}
        phase_recurrent_card_vs_cpu(get_config(arch), sp, lens)
        del sp
        release()
    for part in (counts, moe_counts, rec_counts):
        for k, v in part.items():
            launches[k] += v
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_train_fused(cfg)
    for arch in ("granite-8b", MOE):
        phase_train_cli(arch)
    phase_train_card_vs_cpu(cfg)
    conv = phase_conv(card)
    sp34, r34 = phase_resnet34()
    phase_resnet34_card_vs_cpu(sp34)
    del sp34

    entries = []
    for kname, fname, m, head, dtype, replaces in (
            ("B1", "tiled_matvec", N_SLOTS, True, "bfloat16",
             "src/repro/kernels/tiled_matvec.py:97"),
            ("B2", "tiled_matmul", N_SLOTS * CHUNK, False, "bfloat16",
             "src/repro/kernels/tiled_matmul.py:69"),
            ("B3", "tiled_xnor", N_SLOTS, True, "int",
             "src/repro/kernels/tiled_xnor.py:147"),
            ("B4", "tiled_int8", N_SLOTS, True, "int",
             "src/repro/kernels/tiled_xnor.py:235")):
        tot = tick_totals(results, kname, m, cfg.n_layers, head, dtype)
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
                   f"m={m}, {'bf16' if dtype == 'bfloat16' else 'bf16 activations quantized'}",
        })
        if head:   # the decode kernels at the widest tick, m = MATVEC_MAX_M
            wide = tick_totals(results, kname, MATVEC_M, cfg.n_layers, True, dtype)
            entries[-1]["at_m32"] = {key: wide[key] for key in
                                     ("ms", "library_ms", "bound_ms")}
    per_step = b5_per_step(TRAIN_LAYERS)
    b5_tot = {key: sum(n * b5[(name, "W")][key] for name, n in per_step.items())
              for key in ("ms", "plain_ms", "bound_ms")}
    entries.append({
        "name": "tile_construct", "route": "cuda",
        "source": "src/repro_torch/csrc/tile_construct.cu",
        "replaces": "src/repro/kernels/tile_construct.py:48",
        "launches": train["launches"],
        "max_abs_err": max(v["err"] for v in b5.values()),
        "ms": b5_tot["ms"], "plain_ms": b5_tot["plain_ms"],
        "bound_ms": b5_tot["bound_ms"], "bound_by": "bytes", "library_ms": None,
        "per": f"one train step at L={TRAIN_LAYERS}, B·S={TRAIN_BATCH * TRAIN_SEQ} "
               f"({train['per_step']} calls, f32 masters, alpha from W)",
    })
    b6_tot = conv_forward_totals(conv, R34_BATCH, "bfloat16")
    entries.append({
        "name": "tiled_conv", "route": "cuda",
        "source": "src/repro_torch/csrc/tiled_conv.cu",
        "replaces": "src/repro/kernels/tiled_conv.py:68",
        "launches": r34["launches"],
        "max_abs_err": max(v["err"] for v in conv.values()),
        "ms": b6_tot["ms"], "plain_ms": b6_tot["plain_ms"],
        "bound_ms": b6_tot["bound_ms"],
        "bound_by": "operations" if b6_tot["ops_ms"] >= b6_tot["bytes_ms"] else "bytes",
        "library_ms": b6_tot["library_ms"],
        "per": f"one ResNet-34 ImageNet forward at N={R34_BATCH}, bf16 (18 calls)",
    })
    print(f"card: {card_line()}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
