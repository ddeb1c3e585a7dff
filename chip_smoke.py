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
     with the min-max of its timing reps, the planners' host time per
     decode tick, cached and not, and the host cost of the operator
     dispatch (each kernel is a ``torch.library`` operator,
     ``kernels/_op.py``) on a cold decode tick: its 253 B1 calls through
     the wrapper against the launch alone. Every bound column comes from
     ``repro_torch.roofline``: ``analysis.kernel_terms`` counts a call's
     operations and bytes, ``hw.card`` gives the card's data-sheet peaks by
     its name. B5 (tile
     construction) at the five full-width (p, q) shapes of granite-8b's
     tiled layers, f32 masters, alpha from W and from a separate A, plus a
     q = 500 case through ``ops.tile_construct`` (padding): packed words
     ``torch.equal`` to the plain version, alpha at rtol 1e-5, timed beside
     the plain version and the bound (no single PyTorch call computes B5);
  2b. the planners' picks of B1-B4 (no body survey) at every (K, r) of
     qwen1.5-32b, starcoder2-7b, minitron-8b, mamba2-370m,
     recurrentgemma-2b, chameleon-34b and seamless-m4t-large-v2 that
     granite-8b has not (r = 1096 and 12570 are no multiple of 16, r = 32
     is one filter tile): B1 at m in {1, 4, 32} and B2 at m = 128 (and at
     seamless's encode tick's m = 256), bf16 and f32, at the same
     tolerance; B3 / B4 at m in {1, 4, 32}, equal; each timed beside the
     plain version, the library yardstick and the bound, with the pick;
     then the totals of qwen1.5-32b (L = 64), mamba2-370m (L = 48),
     recurrentgemma-2b (L = 26), chameleon-34b (L = 48) and seamless (24
     decoder layers; its head launches no kernel) per extend tick and per
     decode tick at m = 4 and m = 32, head included, and seamless's per
     encode tick (193 calls at m = 256);
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
  4e. serve qwen2-moe-a2.7b at its published width, cut to
     MOE_SERVE_LAYERS = 12 of its 24 layers when phase 5r made the run
     longer (60 routed experts top-4 plus 4 shared a layer), bf16, from masters
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
  4f. serve moonshot-v1-16b-a3b at its published width, cut to
     MOONSHOT_SERVE_LAYERS = 16 of its 48 layers when phases 4k-4m made
     the run longer (a dense first layer, then 64 routed experts top-6
     plus 2 shared), int8 K/V cache, built the same way: float path,
     4 requests of 8 greedy tokens, cold and warm, the same checks, first
     tokens printed, one decode tick traced cold and warm;
  4g. qwen2-moe-a2.7b at full width, 2 layers, f32: one extend and one
     decode step on the card against the CPU model; every MoE call's
     top-k expert ids and dispatch positions must be equal (a difference
     fails and names the token and the gap between its k-th and (k+1)-th
     router probability), logits at rtol = atol = 1e-3;
  4h. serve mamba2-370m at its published width, cut to
     MAMBA_SERVE_LAYERS = 24 of its 48 layers when phase 4r made the run
     longer (SSD state 128, no attention, no FFN), bf16, built the same
     way: the
     requests of phase 3 under "float", "xnor" and "int8" on one export,
     cold and warm, with the same counter and token checks (own kernel =
     (2 L + 1) per decode tick + 1 per extend tick: in_proj and out_proj),
     no page pool, f32 (h, conv) carries; the warmup captures the slot
     reset too (``reset_slot``), and the warm drain must run no eager
     reset; one 4-slot decode tick traced per path, warm (the cold traces,
     each behind a cold per-token extend tick, were cut when phases 4k-4m
     made the run longer);
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
  4k. serve seamless-m4t-large-v2 at its published width and depth (24
     encoder + 24 decoder layers, d 1024, vocab 256206, p = 4), bf16,
     built the same way (peak printed, must leave 10% of the card): phase
     3's first SEAMLESS_REQUESTS = 4 requests (cut from 8 for the run's
     time), each with its own synthetic clip of 40-256 frames, on
     256-token slots whose encode tick pads to ENC_TOKENS = 256 frames,
     under "float", "xnor" and "int8" on one export, cold and warm, with
     the same checks: own kernel = 8 L per decode tick (self q, k, v, o,
     cross q, o, up, down; the head, vocab 256206 no multiple of p, ships
     as sign bits rebuilt densely at every call and launches no kernel),
     B2 = 8 L per extend tick + (1 + 6 L + 2 L) per encode tick, exactly;
     one encode a request; the warm drain replays the encode tick too
     (no launch, no TRACE_COUNTS move). The encode ticks and one encode
     tick's ms cold and warm, and one 4-slot decode tick traced per path
     with the LM head's share of busy time (timed alone as a CUDA graph:
     the whole head and the dense rebuild) and one head call's graph pool;
  4l. serve chameleon-34b at its published width, cut to
     CHAMELEON_SERVE_LAYERS = 16 of its 48 layers when phase 4r made the
     run longer (d 8192, GQA 64/8, d_ff 22016, QK-norm, p = 8), bf16, built the same way (peak printed): float path,
     4 requests of 8 greedy tokens, cold and warm, own kernel = (7 L + 1)
     per decode tick, first tokens printed, one decode tick traced cold and
     warm;
  4m. card against CPU, f32, full width: seamless at 2 + 2 layers on 4k's
     shipped weights (two slots encode 200 and 57 frames through their
     cross rows, then one extend and one decode step: logits and the cross
     pool's rows at rtol = atol = 1e-3); chameleon at 2 layers on 4l's (one
     extend and one decode step, the QK-norm path, logits at 1e-3);
  4n. the engine's reuse and scheduling features on phase 3's granite-8b
     export (full width, 36 layers, float, warm engines): the prefix trie
     (8 requests of one 96-token prefix and a 3-12-token tail, the first
     drained alone: >= 7 hits skipping 96 tokens each, extend ticks and the
     later requests' TTFT against the cache-off run, equal tokens);
     telemetry on against off (equal tokens, the warm decode and extend
     tick ms, no eager tick in a warm drain, the trace ring's events);
     preemption (4 batch requests of 64-token prompts, 2 interactive ones
     10 ticks later: preempts = resumes >= 1, per-class TTFT, tokens equal
     to preempt=False); abort of a live and of a parked request, then
     abort_all mid-flight (``KVPool.check()``, 0 pages in use outside the
     trie, on_finish once a request);
  4o. mamba2-370m on 4h's export (full width, 24 layers, float, warm):
     the prefix trie with the slot snapshot and restore captured, 4
     requests of one 64-token prefix: the hits restore through the
     replayed graph (no TRACE_COUNTS move, no launch through a wrapper),
     tokens equal to the cache-off run, the bytes the trie's snapshots
     hold;
  4p. seamless-m4t-large-v2 on 4k's export (24 + 24 layers, float, cold):
     8 requests over 2 source clips: 2 encode ticks with the EncoderCache,
     8 without, equal tokens;
  4q. the HTTP/SSE serving shell on phase 3's granite-8b export (full
     width, 36 layers, float): an ``EngineServer`` over a fresh engine of
     phase 3's ServeConfig, ``start(aot=True)`` (the ticks captured as CUDA
     graphs in a worker thread before the socket is bound), 127.0.0.1 port
     0. Phase 3's 8 prompts stream over SSE in a seed-shuffled order, 5 ms
     apart, 16 greedy tokens each: every stream's tokens must equal a warm
     engine's in-process drain, its text ``decode_all`` of them, and one
     non-streaming request its stream; ``stats()["retraces"]`` 0, no
     TRACE_COUNTS move and no launch through a wrapper, ``/metrics`` with
     ``serve_tick_seconds_count`` > 0 and the /generate histogram counting
     every request. Then one long request held live after its 3rd token
     (the tick thread waits in the token hook until ``close()`` stops it)
     and ``close()``: a final ``aborted`` event with the deltas' text, both
     threads joined, 0 live slots, 0 pages outside the trie,
     ``KVPool.check()``. Then ``python -m repro_torch.launch.serve --arch
     granite-8b --reduced --serve --port 0 --stats-interval 0.5`` on the
     card: the readiness line with ``(aot=on)``, one 4-token stream,
     ``/stats`` (``aot_warm``), ``/metrics``, one ``[stats]`` line, then
     SIGINT with a connection open that never sends its request: exit 0
     within 60 s (the stop cuts the silent connection after
     ``drain_timeout``) with ``server closed`` and no traceback. Prints the
     client's TTFT and ITL (mean, p50) beside the drain's, the warm decode
     tick ms inside the server beside the drain's, the detokenize
     backlog's peak and the phase's seconds;
  4r. (after phase 10, before 5r) tensor- and expert-parallel serving under
     a ("data", "model") mesh of ranks that share cuda:0 over gloo (ranks
     sharing one card: no multi-card figure). Phase 3's granite-8b export
     (full width and depth), 4e's qwen2-moe-a2.7b export cut to
     TP_MOE_LAYERS = 2 of its 24 layers and phase 9's ResNet-34 export are
     saved to a temp dir and loaded by 2 ranks (mesh (1, 2)) and then 4
     ((2, 2)), each rank this script run as ``--tp-rank JOB_DIR``. On each
     rank: every per-shard tile of granite's layer 0 and head (r/TP rows)
     through B1 (m = 4), B2 (m = 128), B3 and B4 against the plain
     versions (phase 2's tolerances); in f32 at all 36 layers, prefill of
     one prompt and 4 decode steps within 1e-4 x max|logit| of the single
     card's on the same export; the tile bytes a rank x TP =
     ``tile_serving_bytes``. The engines run granite cut to TP_LAYERS = 2
     of its 36 layers (for the run's time: every rank runs cold eager
     ticks, and each gather stages through the host): phase 3's 8 prompts
     x 16 greedy tokens under float, xnor and int8 give the single-card
     engine's tokens at the same ticks, each rank's launch counters equal
     the single card's and no plain version runs. Under (1, 2) also:
     qwen2-moe (E/TP experts a rank) logits within 1e-4 and engine tokens
     equal; ResNet-34 N = 2 f32 logits within phase 10's 1e-3 (B6 per
     shard, 18 launches a rank); the cold bf16 decode tick at TP_LAYERS
     against one card's and the gathers' share of it (information). Then
     the serve CLI
     under ``torch.distributed.run --nproc-per-node 2 ... --reduced --mesh
     1x2``: exit 0, ``backend=gloo``, ``2.0x sharding``;
  11. (runs last) the dry run against the card: ``launch.dryrun.count_cell``
     builds one rank's cell on ``meta`` tensors under a fake process group
     of the mesh's size and counts its step (``roofline.analysis``); the
     tile bytes a rank of granite-8b serving at (1, 2) equal phase 4r's,
     the collectives a train step and their kinds of granite-8b (L = 2) at
     (1, 2), (2, 1), (2, 2) and of qwen2-moe (L = 2) at (1, 2), (2, 2)
     equal phase 5r's step 2, phase 5d's state bytes and launches equal
     the count, and each remat policy's predicted step peak and forward +
     backward peak (with its launches) lie within DRYRUN_PEAK_TOL of
     phase 5d's ``max_memory_allocated``;
  5r. (runs before 11) training under a ("data", "model") mesh of ranks that
     share cuda:0 over gloo (no multi-card figure): granite-8b at full
     width cut to TRAIN_MESH_LAYERS = 2, fused (B5 + B2 per shard), f32
     masters of seed 0, bf16 compute, phase 5's batch 4 x 512, AdamW 3e-4,
     first on one card, then under (1, 2) and (2, 1) on 2 ranks and (2, 2)
     on 4 (``--train-rank JOB_DIR`` is one rank; the 4-rank job starts
     beside the 2-rank one and trains once it has ended). Before, each
     mesh's bytes a rank are reckoned (masters, gradients, two moments,
     the whole masters built before the cut, activations) and must leave
     10% of the card. On each rank: its B5 words of layer 0's gate equal
     one card's rows and alpha within 1e-5; the losses of 2 steps within
     rtol 1e-3 of one card's, their clip norms within TRAIN_MESH_GNORM_RTOL;
     the update the 2 steps made to its block of each attention and norm
     leaf (TRAIN_MESH_UPDATE_LEAVES) within TRAIN_MESH_UPDATE_TOL of one
     card's (relative, in norm); B5 = B2 = 2 x (14 L + 1) launches, B1 =
     B3 = B4 = B6 = 0, no plain version run; its master bytes, step 2's ms and
     the collectives' share of it (each synchronized) and its peak memory.
     The 2-rank job also runs one EF-sign ``build_dp_train_step`` step at
     (2, 1) (finite loss) and a 2-stage GPipe of full-width blocks (fused,
     one block a stage, M = 4 microbatches of 1 x 128; outputs and stage
     gradients within rtol 1e-3 of the stages in sequence on one rank);
     the 4-rank job writes a checkpoint under (2, 2) (granite-8b reduced,
     3 steps), which ``elastic_restore`` puts onto one card: every leaf's
     sha256 equals the state the ranks gathered. Beside the 4-rank job the
     train CLI under ``torch.distributed.run --nproc-per-node 2 ...
     --reduced --steps 3 --mesh 1x2`` exits 0 with ``done: 3 steps``. Each
     job also trains qwen2-moe-a2.7b at full width cut to TP_MOE_LAYERS = 2
     (60 experts, top-4, 4 shared) under its model-axis mesh ((1, 2), (2,
     2)), a rank holding E/TP experts' masters (built one leaf at a time),
     by SGD without momentum (AdamW's moments of 4 ranks would not fit the
     card): losses and clip norms of 2 steps against one card's at the
     granite tolerances, B5 = B2 = 2 x (14 L + 1) a rank, no plain
     version, the experts held, step 2's ms and collectives;
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
  5d. one fused step of phase 5's model, masters and first batch under
     remat "none", "full" and "dots" (the selective checkpoint that saves
     the matrix products, B2's included): "dots" gives "full"'s loss within
     rtol 1e-3, launches B2 7 L + 1 times ("none"'s) against "full"'s
     14 L + 1 and B5 14 L + 1 times (recomputed); then a forward +
     backward alone on REMAT_BATCH x 512 rows, where the activations set
     the peak (the step's peak is AdamW's, one figure for all three), with
     the same launches: its peaks fall strictly, none > dots > full; the
     state's bytes, the launches and each peak go to phase 11;
  6. the training CLI on the card (unfused default path): ``python -m
     repro_torch.launch.train --arch granite-8b --reduced --steps 3`` and
     the same with ``--arch qwen2-moe-a2.7b`` (the MoE TRAIN dispatch) and
     ``--arch seamless-m4t-large-v2`` (synthetic frames, the encoder) must
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

import atexit
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
    # p = 8: r = n_out / 8
    "chameleon-34b": (("q/o", 8192, 1024, 2), ("k/v", 8192, 128, 2),
                      ("gate/up", 8192, 2752, 2), ("down", 22016, 1024, 1),
                      ("lm_head", 8192, 8192, 0)),
    # p = 4; calls per decoder layer of a decode or extend tick: self q, k,
    # v, o and cross q, o, then the FFN's up and down. The head (vocab
    # 256206, no multiple of p) ships as sign bits and launches no kernel
    "seamless-m4t-large-v2": (("q/k/v/o", 1024, 256, 6), ("up", 1024, 2048, 1),
                              ("down", 8192, 256, 1)),
}
MAMBA, RECGEMMA = "mamba2-370m", "recurrentgemma-2b"
SEAMLESS, CHAMELEON = "seamless-m4t-large-v2", "chameleon-34b"
# the layers that FAMILY_SHAPES' per-layer counts multiply in a tick
FAMILY_TICK_LAYERS = {"qwen1.5-32b": 64, MAMBA: 48, RECGEMMA: 1, CHAMELEON: 48,
                      SEAMLESS: 24}
# phase 4k serves seamless on 256-token slots; each request brings a clip of
# ENC_FRAMES frames, padded to ENC_TOKENS by the encode tick (m = 256 -> B2
# on every path). ENCODE_CALLS: the B2 calls of one encode tick by (K, r):
# frame_proj and each encoder layer's q, k, v, o; its up; its down; and
# each decoder layer's cross k, v (with the (1024, 256) ones)
ENC_TOKENS, ENC_MAX_LEN, ENC_FRAMES = 256, 256, (40, 257)
# phase 4k's requests a path (cut from 8 for the run's time, to make room
# for phase 5r's MoE jobs and phase 11)
SEAMLESS_REQUESTS = 4
ENCODE_CALLS = {"K1024 r256": 1 + 4 * 24 + 2 * 24, "K1024 r2048": 24,
                "K8192 r256": 24}
# phase 4m: seamless cut to 2 + 2 layers, chameleon to 2, card vs CPU
ENCDEC_CHECK_LAYERS = 2
# phase 4l serves chameleon-34b at full width cut to 16 of its 48 layers,
# and phases 4h / 4o mamba2-370m to 24 of its 48 (its cold per-token extend
# ticks): phase 4r made the run longer, and these depths were the next cuts
CHAMELEON_SERVE_LAYERS = 16
MAMBA_SERVE_LAYERS = 24
# phase 4f serves moonshot-v1-16b-a3b at full width cut to 16 of its 48
# layers: phases 4k-4m made the run longer, and this depth was the next cut
MOONSHOT_SERVE_LAYERS = 16
# phase 4e's depth: 12 of qwen2-moe-a2.7b's 24 layers (the run's time, when
# phase 5r joined it; 4g and 4r check the MoE layers on the card at L = 2)
MOE_SERVE_LAYERS = 12
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
# phase 4r: the meshes (data, model) of its two jobs; granite-8b's engines
# and timed ticks cut to TP_LAYERS of its 36 layers (its logits check runs
# all 36) and qwen2-moe-a2.7b to TP_MOE_LAYERS of 24 (the run's time: every
# rank runs cold eager ticks with a gather per tiled layer), the prompt of the logits check, the tokens a request, the
# tolerances (logits: of max|logit|; ResNet-34: phase 10's), the decode
# ticks timed, and a job's time limit; TP_DIR holds the saved exports
TP_MESHES = ((1, 2), (2, 2))
TP_LAYERS, TP_MOE_LAYERS = 2, MOE_CHECK_LAYERS
TP_PROMPT, TP_DECODE_STEPS, TP_MAX_TOKENS = [5, 3, 2, 7, 1, 4, 6, 2], 4, 16
TP_LOGIT_RTOL, TP_R34_TOL = 1e-4, 1e-3
TP_TIMED_TICKS, TP_JOB_TIMEOUT = 5, 300
TP_DIR = None
# phase 5r: granite-8b training at full width cut to TRAIN_MESH_LAYERS under
# the meshes (data, model) of its two jobs (ranks sharing cuda:0 over gloo),
# TRAIN_MESH_STEPS steps checked against one card at TRAIN_MESH_RTOL (phase
# 5's tolerance: atomics) and one more timed with the collectives timed; the
# 2-stage GPipe of full-width blocks (one block a stage), its microbatches
# and their tokens; the checkpoint case trains granite-8b reduced
TRAIN_MESH_LAYERS, TRAIN_MESH_STEPS, TRAIN_MESH_RTOL = 2, 2, 1e-3
# each step's clip norm against one card's (rtol), and the update the
# steps made to the attention and norm leaves of both layers against one
# card's: ||d - d_1|| / ||d_1|| over the rank's block of each leaf, d =
# params after the steps - params before (a skipped optimizer step gives
# 1). Layer 0's attention gradient is the whole backward's (every later
# Dense's dx partials and the DP mean reach it). Sound runs of the three
# meshes (NVIDIA H100 80GB HBM3, 700 W) gave clip norms within 8.1e-4 and
# updates within 0.108 (0.189 over every leaf): bf16 rounding flips a few
# AdamW signs; the bounds are 2.5x and 3.7x those
TRAIN_MESH_GNORM_RTOL, TRAIN_MESH_UPDATE_TOL = 2e-3, 0.4
TRAIN_MESH_UPDATE_LEAVES = ("seg0/mixer", "seg0/norm1", "seg0/norm2", "final_norm")
TRAIN_MESH_JOBS = (((1, 2), (2, 1)), ((2, 2),))
PARTS_5R = (("ef_sign", "gpipe", "moe"), ("ckpt", "moe"))
GPIPE_MICRO, GPIPE_MB, GPIPE_SEQ = 4, 1, 128
TRAIN_MESH_LR = 3e-4
# phase 5r's MoE jobs: qwen2-moe-a2.7b at full width cut to TP_MOE_LAYERS,
# under the jobs' model-axis meshes, a rank holding E/TP experts' masters,
# trained by SGD without momentum (4 ranks' AdamW moments of ~1.04 B params
# each, beside their masters and gradients, would not fit one 80 GB card)
MOE_TRAIN_MESHES = ((1, 2), (2, 2))
# phase 5d: one fused step of phase 5's model, masters and batch under each
# remat policy
REMAT_MODES = ("none", "full", "dots")
# and a forward + backward alone (no optimizer) of REMAT_BATCH x TRAIN_SEQ
# rows, a batch at which the activations set its peak: at phase 5's 4 x 512
# the 5.1 GB of gradients do (the meta count gives dots' peak = full's
# there), and the whole step's peak is AdamW's (one figure for every policy)
REMAT_BATCH = 16
# the dry-run phase: a predicted peak (a step's: its state and batch plus
# the most bytes the meta step's ops hold alive; a forward + backward's:
# the most its ops hold alive) against the card's
# torch.cuda.max_memory_allocated over the same region less what was
# allocated before it, as a ratio within this much of 1 (the meta run sees
# no kernel's split-K scratch, no cuBLAS workspace and no allocator
# rounding: together tens of MB, under 1% of the smallest peak, ~8.7 GB;
# on an H100 the ratios were 0.9972-1.0000)
DRYRUN_PEAK_TOL = 0.02


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


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


def check_kernel(kernel, plain, x, packed, card, survey: bool = True):
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
    from repro_torch.roofline.analysis import kernel_terms

    dense = unpack_rows(packed).to(x.dtype)
    m, k = x.shape
    r = packed.shape[0]
    work = kernel_terms("B1" if kernel.__name__ == "tiled_matvec_unique" else "B2",
                        x.shape, packed.shape, x.dtype)
    t_bytes, t_ops = work.times_ms(card)
    res = dict(err=err, scale=scale, flops=work.ops, bound_ms=max(t_bytes, t_ops),
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


def check_int_kernel(path: str, m: int, n_in: int, r: int, gen, card,
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
    from repro_torch.roofline.analysis import kernel_terms

    work = kernel_terms("B3" if path == "xnor" else "B4", a.shape, packed.shape,
                        a.dtype)
    t_bytes, t_ops = work.times_ms(card)
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
    from repro_torch.roofline import hw

    hwc = hw.card(card)  # data-sheet peaks by the nvidia-smi name
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    ks = kernels()
    results = {}
    both = (torch.bfloat16, torch.float32)
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
            for dtype in dtypes:
                for m in ms:
                    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
                    res = check_kernel(kernel, plain, x, packed, hwc)
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
            check_int_kernel(path, m, 80, 24, gen, hwc, with_times=False)
        for name, k, r, _ in SHAPES:
            for m in INT_MS:
                res = check_int_kernel(path, m, k, r, gen, hwc)
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
    dispatcher_cost(card)
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


def dispatcher_cost(card: str) -> dict:
    """Host cost of the operator dispatch (``kernels/_op.py``) on a cold
    eager decode tick: the 253 B1 calls of one granite-8b decode tick at
    L=36, m = 4, bf16, issued through the wrapper (checks, the
    ``repro_torch::tiled_matvec_unique`` operator, the launch) and through
    the launch alone, the card synchronized after each tick; the median of
    9 ticks each, alternated. Returns the two in ms and their difference."""
    import torch

    from repro_torch.kernels import tiled_matvec

    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    ops = {}
    for name, k, r, _ in SHAPES:
        ops[name] = (torch.randn((N_SLOTS, k), generator=gen, device="cuda").to(
            torch.bfloat16), torch.randint(0, 2**32, (r, k // 32), generator=gen,
                                           device="cuda", dtype=torch.int64
                                           ).to(torch.int32))
    calls = [ops[name] for name, _, _, per in SHAPES
             for _ in range(per * 36 + (name == "lm_head"))]
    ways = {"operator": tiled_matvec.tiled_matvec_unique,
            "launch": lambda x, p: tiled_matvec._launch(x, p, None)}
    times = {w: [] for w in ways}
    for _ in range(10):
        for way, fn in ways.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for x, p in calls:
                fn(x, p)
            torch.cuda.synchronize()
            times[way].append(1e3 * (time.perf_counter() - t0))
    med = {w: statistics.median(v[1:]) for w, v in times.items()}
    med["cost"] = med["operator"] - med["launch"]
    print(f"operator dispatch on a cold decode tick (granite-8b L=36, m={N_SLOTS}, "
          f"{len(calls)} B1 calls, bf16, median of 9, {card}): through the operator "
          f"{med['operator']:.3f} ms, the launch alone {med['launch']:.3f} ms: "
          f"{med['cost']:.3f} ms a tick, {1e3 * med['cost'] / len(calls):.2f} us a "
          f"call", flush=True)
    return med


def shape_key(k: int, r: int) -> str:
    """Where phase 2b stores the measurements of a FAMILY_SHAPES entry: by
    (K, r), so that two configs' equal shapes are one measurement."""
    return f"K{k} r{r}"


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
    from repro_torch.roofline import hw

    t0 = time.perf_counter()
    hwc = hw.card(card)  # data-sheet peaks by the nvidia-smi name
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    ks = kernels()
    seen = {(k, r) for _, k, r, _ in SHAPES}
    for arch in FAMILY_SHAPES:
        for name, k, r, _ in FAMILY_SHAPES[arch]:
            key = shape_key(k, r)
            if (k, r) in seen:
                continue
            seen.add((k, r))
            packed = torch.randint(0, 2**32, (r, k // 32), generator=gen,
                                   device="cuda", dtype=torch.int64).to(torch.int32)
            b2_ms = ((N_SLOTS * CHUNK, ENC_TOKENS) if arch == SEAMLESS
                     else (N_SLOTS * CHUNK,))
            for kname, plain, ms in (("B1", tiled_matvec_plain, FAMILY_MS),
                                     ("B2", tiled_matmul_plain, b2_ms)):
                for dtype in (torch.bfloat16, torch.float32):
                    dt = str(dtype).split(".")[-1]
                    for m in ms:
                        x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
                        res = check_kernel(ks[kname], plain, x, packed, hwc,
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
                    res = check_int_kernel(path, m, k, r, gen, hwc,
                                           survey=False)
                    results[(kname, m, "int", key)] = res
                    print(f"{kname} {arch} {name:8s} K={k:5d} r={r:5d} m={m:3d} "
                          f"{path:8s} exact (max|acc|={res['scale']:.0f}) kernel "
                          f"{res['ms']:.4f}ms plain {res['plain_ms']:.4f}ms library "
                          f"{res['library_ms']:.4f}ms bound {res['bound_ms']:.4f}ms"
                          f"{bodies_line(res)}", flush=True)
    for arch, n_layers in FAMILY_TICK_LAYERS.items():
        shapes = FAMILY_SHAPES[arch]
        calls = sum(per for *_, per in shapes) * n_layers
        head = int(any(name == "lm_head" for name, *_ in shapes))
        m = N_SLOTS * CHUNK
        tot = tick_totals(results, "B2", m, n_layers, False, shapes=shapes,
                          family=True)
        print(f"B2 {arch} per extend tick, m={m}, bf16 ({calls} calls): "
              f"kernel {tot['ms']:.3f}ms plain {tot['plain_ms']:.3f}ms library "
              f"{tot['library_ms']:.3f}ms bound {tot['bound_ms']:.3f}ms", flush=True)
        for kname, dtype in (("B1", "bfloat16"), ("B3", "int"), ("B4", "int")):
            for m in (N_SLOTS, MATVEC_M):
                tot = tick_totals(results, kname, m, n_layers, True, dtype, shapes,
                                  family=True)
                print(f"{kname} {arch} per decode tick, m={m}, {dtype} "
                      f"({calls + head} calls): kernel {tot['ms']:.3f}ms (reps "
                      f"{tot['ms_lo']:.3f}-{tot['ms_hi']:.3f}) plain "
                      f"{tot['plain_ms']:.3f}ms library "
                      f"{tot['library_ms']:.3f}ms (reps {tot['library_ms_lo']:.3f}-"
                      f"{tot['library_ms_hi']:.3f}) bound {tot['bound_ms']:.3f}ms",
                      flush=True)
    enc = {key: sum(results[("B2", ENC_TOKENS, "bfloat16", k)][key] * n
                    for k, n in ENCODE_CALLS.items())
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    print(f"B2 {SEAMLESS} per encode tick, m={ENC_TOKENS}, bf16 "
          f"({sum(ENCODE_CALLS.values())} calls): kernel {enc['ms']:.3f}ms plain "
          f"{enc['plain_ms']:.3f}ms library {enc['library_ms']:.3f}ms bound "
          f"{enc['bound_ms']:.3f}ms", flush=True)
    torch.cuda.empty_cache()
    print(f"phase 2b (dense, SSM, hybrid, VLM and encoder-decoder family "
          f"shapes): {time.perf_counter() - t0:.1f}s", flush=True)


def tick_totals(results, kname: str, m: int, n_layers: int, with_head: bool,
                dtype: str = "bfloat16", shapes=SHAPES, family: bool = False):
    """Sum the per-shape measurements over the calls of one engine tick
    (``family``: FAMILY_SHAPES entries, measured under their (K, r) key)."""
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               bytes_ms=0.0, ops_ms=0.0, ms_lo=0.0, ms_hi=0.0,
               library_ms_lo=0.0, library_ms_hi=0.0)
    for name, k, r, per_layer in shapes:
        n = per_layer * n_layers + (1 if name == "lm_head" and with_head else 0)
        res = results[(kname, m, dtype, shape_key(k, r) if family else name)]
        for key in tot:
            tot[key] += n * res[key]
    return tot


def layer_calls(cfg) -> int:
    """Tiled projections of every layer of one decode tick (the LM head
    apart): an attention layer's q, k, v, o, an RG-LRU layer's in_x,
    in_gate, out, w_a, w_i, each with the MLP's (gate, up, down, or up,
    down); a mamba2 layer's in_proj and out_proj; an MoE layer's
    MOE_DENSE_CALLS; a seamless decoder layer's self q, k, v, o, cross q,
    o, up and down."""
    if cfg.family == "moe":
        return MOE_DENSE_CALLS[cfg.name] * cfg.n_layers
    if cfg.family == "ssm":
        return 2 * cfg.n_layers
    if cfg.family == "encdec":
        return 8 * cfg.dec_layers
    mlp = 3 if cfg.gated_mlp else 2
    kinds = ([cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.n_layers)]
             if cfg.family == "hybrid" else ["attn"] * cfg.n_layers)
    return sum((5 if k == "rec" else 4) + mlp for k in kinds)


def head_calls(cfg) -> int:
    """Kernel calls of the LM head in a tick: seamless's head (vocab
    256206, no multiple of p = 4) ships as sign bits that every call
    rebuilds to the dense weight, as in the reference: no kernel."""
    return 0 if cfg.family == "encdec" else 1


def encode_calls(cfg) -> int:
    """B2 calls of one encode tick (m = ENC_TOKENS): frame_proj, each
    encoder layer's q, k, v, o, up, down and each decoder layer's cross k,
    v; 0 without an encoder."""
    if cfg.family != "encdec":
        return 0
    return 1 + 6 * cfg.enc_layers + 2 * cfg.dec_layers


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
    trees = eng.caches if isinstance(eng.caches, list) else [eng.caches]
    got = {"/".join(p): v.dtype for c in trees for p, v in mod.walk(c)}
    bad = {k: v for k, v in got.items() if v != want[k.split("/")[-1]]}
    if bad or not got:
        fail(f"{label}: cache leaves of unexpected type {bad} (of {got})")


def serve_engine(s_model, sp, path: str, n_slots: int = N_SLOTS):
    """The serve runs' engine: 128-token slots; an encoder-decoder model's
    ENC_MAX_LEN-token slots with ENC_TOKENS-frame encodes."""
    from repro_torch.serve.engine import BatchedEngine, ServeConfig

    cross = s_model.has_cross_attn
    return BatchedEngine(s_model, sp, ServeConfig(
        n_slots=n_slots, max_len=ENC_MAX_LEN if cross else 128,
        chunk_tokens=CHUNK, page_tokens=16, compute_path=path,
        enc_tokens=ENC_TOKENS if cross else None))


def synthetic_frames(cfg, rng, n: int):
    """An encoder-decoder model's source clips (ENC_FRAMES frames each),
    one a request; None for any other model."""
    from repro_torch.launch.serve import synthetic_clips

    if cfg.family != "encdec":
        return None
    return synthetic_clips(rng, n, cfg.d_model, *ENC_FRAMES)


def release() -> None:
    """Collect a dropped engine and its graphs (its tick functions and
    graphs refer to each other, so it takes a collection) and return the
    memory to the card."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def drive(eng, cfg, prompts, max_tokens: int, frames=None):
    """Submit ``prompts`` (``max_tokens`` greedy tokens each; with
    ``frames``, each request's source clip) and drain, with every launch
    counter set to 0 just before and read just after. Returns the
    measurements of the run."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import drain, latency_report
    from repro_torch.serve.sampling import SamplingParams

    reqs = [eng.submit(p, SamplingParams(max_tokens=max_tokens),
                       frames=None if frames is None else frames[i])
            for i, p in enumerate(prompts)]
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
                steps=[r.token_steps for r in reqs], tick_ends=tick_ends,
                ttft=1e3 * float(np.mean(ttfts)), ttft_max=1e3 * float(np.max(ttfts)),
                ttft_p50=1e3 * float(np.median(ttfts)),
                itl=1e3 * float(np.mean(itls)), itl_max=1e3 * float(np.max(itls)),
                itl_p50=1e3 * float(np.median(itls)))


def serve_run(cfg, s_model, sp, path: str, requests: int = 8,
              max_tokens: int = 16, profile_ticks: int = 3, wide: bool = True,
              cold_profile: bool = True):
    """Drive ``requests`` prompts of 3-100 tokens, ``max_tokens`` greedy
    tokens each, through a BatchedEngine under ``path``, cold (eager ticks)
    and then warm (a new engine, ``warmup()``, the same prompts: the ticks
    replay CUDA graphs). Cold: every launch counter is 0 just before the run
    and read just after it; asserts the caches' families and types
    (:func:`check_caches`), that the path's decode kernel took every
    m <= 32 projection, B2 every extend, and no other kernel ran. Warm: see
    :func:`warm_run`. Then traces ``profile_ticks`` 4-slot decode ticks cold
    and warm (warm only without ``cold_profile``) and, with ``wide``, one of
    32 slots. Returns the cold counts."""
    import numpy as np

    from repro_torch.launch.serve import synthetic_prompts

    eng = serve_engine(s_model, sp, path)
    check_caches(eng, cfg, f"{cfg.name} {path}")
    rng = np.random.default_rng(0)
    prompts = synthetic_prompts(rng, requests, cfg.vocab, 3, 101)
    frames = synthetic_frames(cfg, rng, requests)
    cold = drive(eng, cfg, prompts, max_tokens, frames)
    enc_ms = encode_tick_ms(eng) if frames else None
    del eng
    release()
    counts, st = cold["counts"], cold["st"]
    label = f"{cfg.name} {path}"
    if st["decode_ticks"] == 0 or st["extend_ticks"] == 0:
        fail(f"{label}: the run had {st['decode_ticks']} decode and "
             f"{st['extend_ticks']} extend ticks; both must run")
    own, head = PATH_KERNEL[path], head_calls(cfg)
    need = ((layer_calls(cfg) + head) * st["decode_ticks"]
            + head * st["extend_ticks"])
    # an encoder-decoder run: every projection of its extend and encode
    # ticks through B2, exactly; the other families: at least one a tick
    b2 = (layer_calls(cfg) * st["extend_ticks"]
          + encode_calls(cfg) * st["encode_ticks"]) if frames else None
    others = [k for k in ("B1", "B3", "B4", "B5", "B6") if k != own]
    if (counts[own] != need or counts["B2"] < st["extend_ticks"]
            or (b2 is not None and (counts["B2"] != b2
                                    or st["encode_ticks"] != requests))
            or any(counts[k] for k in others)):
        fail(f"{label}: launch counters {counts}, {st['encode_ticks']} encode "
             f"ticks; need {own} = {need}, B2 "
             f"{'= ' + str(b2) if b2 is not None else '>= ' + str(st['extend_ticks'])}, "
             f"{others} = 0: the main path did not go through the kernels")
    print(f"serve [{label}] cold: {requests} requests, {cold['tok']} tokens in "
          f"{cold['ticks']} ticks ({st['extend_ticks']} extend, {st['decode_ticks']} "
          f"decode), {cold['dt']:.3f}s, {cold['tok'] / cold['dt']:.1f} tok/s | TTFT "
          f"mean {cold['ttft']:.1f}ms max {cold['ttft_max']:.1f}ms | ITL mean "
          f"{cold['itl']:.2f}ms max {cold['itl_max']:.2f}ms | extend tick "
          f"{st['extend_ms_mean']:.2f}ms decode tick {st['decode_ms_mean']:.2f}ms | "
          f"launches " + " ".join(f"{k}={v}" for k, v in counts.items()), flush=True)
    print(f"serve [{label}]: first requests' tokens {cold['tokens'][:2]}")
    if frames:
        fam = ", ".join(f"{k} {v['pages']} pages" for k, v in
                        st["cache_families"].items())
        print(f"serve [{label}] cold: {st['encode_ticks']} encode ticks of "
              f"{ENC_TOKENS} frames (clips of {min(map(len, frames))}-"
              f"{max(map(len, frames))}), {encode_calls(cfg)} B2 calls each; "
              f"one encode tick {enc_ms:.2f} ms (eager, host to device done); "
              f"cache families {fam}", flush=True)
    warm = warm_run(cfg, s_model, sp, path, prompts, max_tokens, cold, frames)
    if profile_ticks:
        runs = ((st["decode_ms_mean"], False), (warm["st"]["decode_ms_mean"], True))
        for ms, is_warm in runs if cold_profile else runs[1:]:
            profile_decode(s_model, sp, cfg, ms, path, n_ticks=profile_ticks,
                           warm=is_warm)
    if wide:   # the widest decode tick: every projection at m = 32
        for is_warm in (False, True):
            profile_decode(s_model, sp, cfg, None, path, n_ticks=1,
                           n_slots=WIDE_SLOTS, warm=is_warm)
    return counts


def encode_tick_ms(eng, n: int = 5) -> float:
    """Median wall ms of ``n`` encode ticks of a drained engine (eager, or
    a graph replay once warm), each from its launch to the device's end:
    all frames masked, so every cross write lands on the scratch page (the
    work is the same at the tick's one shape)."""
    import torch

    eng._frames_t.zero_()
    eng._valid_t.zero_()
    eng._xrow_t.zero_()
    times = []
    with torch.no_grad():
        for _ in range(n + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng._tick("encode_tick")
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times[1:])


def warm_run(cfg, s_model, sp, path: str, prompts, max_tokens: int, cold,
             frames=None):
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
    own, per_layer, head = PATH_KERNEL[path], layer_calls(cfg), head_calls(cfg)
    # decode: every projection and the head; extend: B2, its head on `own`;
    # encode: B2
    want = {k: 0 for k in captured}
    want[own] = (WARM_RUNS + 1) * (per_layer + 2 * head)
    want["B2"] = (WARM_RUNS + 1) * (per_layer + encode_calls(cfg))
    if captured != want or not eng.aot_warm:
        fail(f"{label}: warmup launched {captured}, expected {want} "
             f"({WARM_RUNS} warm-up runs and one capture of each tick)")
    traces = TRACE_COUNTS.copy()
    run = drive(eng, cfg, prompts, max_tokens, frames)
    st = run["st"]
    enc_ms = encode_tick_ms(eng) if frames else None
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
    if frames:
        print(f"serve [{label}] warm: {st['encode_ticks']} encode ticks replayed; "
              f"one encode tick {enc_ms:.2f} ms (replay, host to device done)",
              flush=True)
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

    from repro_torch.serve.engine import DECODE

    eng = serve_engine(s_model, sp, path, n_slots)
    if warm:
        eng.warmup()
    rng = np.random.default_rng(2)
    prompt = max(1, CHUNK // n_slots)   # all prompts in one extend tick's budget
    frames = synthetic_frames(cfg, rng, n_slots)
    for i in range(n_slots):
        eng.submit(rng.integers(0, cfg.vocab, size=prompt),
                   SamplingParams(max_tokens=n_ticks + 3 + n_slots),
                   frames=None if frames is None else frames[i])
    # step until every slot decodes (one extend tick; an encoder-decoder
    # model first encodes one request a tick), then one decode tick more
    while any(ph != DECODE for ph in eng._phase):
        eng.step()
    eng.step()
    before = {k: eng.stats()[k] for k in ("extend_ticks", "encode_ticks")}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_ticks):
            eng.step()
        torch.cuda.synchronize()
    if {k: eng.stats()[k] for k in before} != before:
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
    if cfg.family == "encdec":
        head_share(s_model, sp, n_slots, busy_ms)
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
        print(f"  {t / n_ticks:8.3f} ms/tick {n // n_ticks:5d}x  {name[:90]}")


HEAD_PARTS = {}


def head_share(s_model, sp, n_slots: int, busy_ms: float) -> None:
    """Seamless's LM head in a decode tick of ``n_slots`` rows: its sign
    bits (256206, 32 words) rebuilt to the dense bf16 weight times alpha
    (``Dense``'s BWNN branch, as in the reference), then the product. The
    whole head and the rebuild alone, each timed as a CUDA graph of 5
    calls, median of 5 replays, against the tick's busy time; and the bytes
    a graph of one head call takes in its own pool."""
    import torch

    from repro_torch.core.packing import unpack_bits

    head, p = s_model.head, sp["head"]
    key = (s_model.cfg.name, n_slots)     # the same head under every path
    if key not in HEAD_PARTS:
        cd = s_model.ctx.compute_dtype
        x = torch.randn((n_slots, 1, head.n_in), device="cuda").to(cd)
        with torch.no_grad():
            head_ms = time_ms(lambda: head(p, x), iters=5, reps=5)
            rebuild_ms = time_ms(lambda: unpack_bits(p["wbits"], head.n_in, dtype=cd)
                                 * p["alpha"].to(cd), iters=5, reps=5)
            release()
            before = torch.cuda.memory_reserved()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=torch.cuda.graph_pool_handle()):
                head(p, x)
            pool = torch.cuda.memory_reserved() - before
        del graph
        release()
        HEAD_PARTS[key] = head_ms, rebuild_ms, pool
    head_ms, rebuild_ms, pool = HEAD_PARTS[key]
    print(f"  LM head ({head.n_out} x {head.n_in} sign bits, no kernel): "
          f"{head_ms:.3f} ms a tick timed alone ({head_ms / busy_ms:.3f} of busy), "
          f"of which the dense rebuild {rebuild_ms:.3f} ms "
          f"({rebuild_ms / busy_ms:.3f}); one head call's graph pool "
          f"{pool / 1e9:.2f} GB", flush=True)


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


def phase_card_vs_cpu(cfg, sp, paths=tuple(PATH_KERNEL)):
    """Phase 4: full width, 2 layers, f32, card model vs CPU model under
    ``paths`` (the integer ones also at the layer level); phase 4m runs it
    for chameleon-34b on the float path (its QK-norm)."""
    import numpy as np
    import torch

    from repro_torch.configs import build_model
    from repro_torch.nn import module as mod
    from repro_torch.nn.context import SERVE, ModelContext

    if paths != ("float",):
        int_layers_card_vs_cpu(cfg)
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    sp2 = dict(sp, seg0=mod.map_tree(lambda v: v[:2].contiguous(), sp["seg0"]))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, size=(2, 24))
    nxt = rng.integers(0, cfg.vocab, size=(2, 1))
    params = {dev: mod.map_tree(lambda v: v.to(dev), sp2) for dev in ("cuda", "cpu")}
    for path in paths:
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
        print(f"model card vs CPU [{cfg.name} {path}] (L=2, full width, f32): extend "
              f"max|diff| {errs[0]:.2e}, decode max|diff| {errs[1]:.2e} "
              f"{verdict}", flush=True)


def phase_encdec_card_vs_cpu(cfg, sp):
    """Phase 4m (seamless-m4t-large-v2): ENCDEC_CHECK_LAYERS encoder and
    decoder layers at full width, f32, on the card (kernels) against the
    CPU model (plain versions), from the shipped params of 4k: each of two
    slots' ENCODE (``encode_serve`` of 200 and 57 frames padded to
    ENC_TOKENS, ``write_cross`` through its cross table row), then one
    extend (24 and 17 of 24 columns) and one decode step; logits and the
    cross pool's rows at rtol = atol = 1e-3."""
    import numpy as np
    import torch

    from repro_torch.configs import build_model
    from repro_torch.nn import module as mod
    from repro_torch.nn.context import SERVE, ModelContext

    t0 = time.perf_counter()
    n = ENCDEC_CHECK_LAYERS
    cfg2 = dataclasses.replace(cfg, enc_layers=n, dec_layers=n, n_layers=2 * n)
    sp2 = dict(sp, **{k: mod.map_tree(lambda v: v[:n].contiguous(), sp[k])
                      for k in ("enc", "dec")})
    rng = np.random.default_rng(1)
    enc_lens = np.array([200, 57], np.int32)
    frames = rng.standard_normal((2, ENC_TOKENS, cfg.d_model)).astype(np.float32)
    valid = np.arange(ENC_TOKENS)[None, :] < enc_lens[:, None]
    frames *= valid[..., None]
    x_npp = ENC_TOKENS // 16
    xptab = np.arange(2 * x_npp, dtype=np.int32).reshape(2, x_npp)[:, ::-1].copy()
    tokens = rng.integers(0, cfg.vocab, size=(2, 24))
    nxt = rng.integers(0, cfg.vocab, size=(2, 1))
    out = {}
    for dev in ("cuda", "cpu"):
        params = mod.map_tree(lambda v: v.to(dev), sp2)
        model = build_model(cfg2, ModelContext(policy=cfg.tbn, mode=SERVE,
                                               compute_dtype=torch.float32,
                                               device=dev))
        caches = model.init_caches(2, 64, torch.float32, page_tokens=16,
                                   n_pages=8, cross_pages=2 * x_npp)
        t = {k: torch.from_numpy(v).to(dev) for k, v in (
            ("frames", frames), ("valid", valid), ("xptab", xptab),
            ("enc_lens", enc_lens), ("tokens", tokens), ("nxt", nxt))}
        pos = torch.arange(ENC_TOKENS, device=dev)[None, :]
        ptab = torch.arange(8, dtype=torch.int32, device=dev).reshape(2, 4)
        lengths = torch.zeros(2, dtype=torch.int32, device=dev)
        n_new = torch.tensor([24, 17], dtype=torch.int32, device=dev)
        cross = dict(cross_page_table=t["xptab"], enc_lens=t["enc_lens"])
        with torch.no_grad():
            for b in range(2):
                mem = model.encode_serve(params, t["frames"][b:b + 1],
                                         t["valid"][b:b + 1])
                model.write_cross(params, mem, caches, t["xptab"][b:b + 1], pos,
                                  t["valid"][b:b + 1])
            le, caches, lengths = model.extend(params, t["tokens"], caches, lengths,
                                               n_new, ptab, **cross)
            ld, _, _ = model.decode_step(params, t["nxt"], caches, lengths, ptab,
                                         **cross)
        out[dev] = [v.cpu() for v in (le, ld, caches["cross"]["k"][:, :-1],
                                      caches["cross"]["v"][:, :-1])]
        del params, model, caches
        release()
    errs = []
    for name, a, b in zip(("extend logits", "decode logits", "cross K rows",
                           "cross V rows"), out["cuda"], out["cpu"]):
        if not torch.isfinite(a).all():
            fail(f"{cfg.name} card {name} are not finite")
        errs.append(f"{name} max|diff| {float((a - b).abs().max()):.2e}")
        if not torch.allclose(a, b, rtol=1e-3, atol=1e-3):
            fail(f"{cfg.name} card vs CPU {name} differ: {errs[-1]}")
    print(f"model card vs CPU [{cfg.name} float] (L={n}+{n}, full width, f32; two "
          f"encodes of 200 and 57 frames, extend, decode): {', '.join(errs)} "
          f"(rtol=atol=1e-3) OK; {time.perf_counter() - t0:.1f}s", flush=True)


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
    depth = (f"{cfg.enc_layers}+{cfg.dec_layers}" if cfg.family == "encdec"
             else cfg.n_layers)
    print(f"serve {cfg.name}: L={depth} d={cfg.d_model} heads={cfg.n_heads}/"
          f"{cfg.n_kv} d_ff={cfg.d_ff} vocab={cfg.vocab} p={cfg.tbn.p} kv "
          f"{cfg.kv_dtype} bf16: masters {master_b / 1e9:.2f}GB -> shipped "
          f"{serving_bytes(sp) / 1e9:.3f}GB, built one master leaf at a time in "
          f"{time.perf_counter() - t0:.1f}s; peak device memory in the build "
          f"{peak / 1e9:.2f}GB of {card / 1e9:.2f}GB", flush=True)
    if peak > 0.9 * card:
        fail(f"{cfg.name}: the build's peak {peak / 1e9:.2f}GB leaves under 10% "
             f"of the card's {card / 1e9:.2f}GB")
    return s_model, sp, master_b


def phase_serve_paths(cfg, phase: str, cold_profile: bool = True,
                      requests: int = 8):
    """Phases 4b, 4e and 4k: ``cfg`` at its published width and the depth it
    is given (qwen1.5-32b with its int8 KV cache; qwen2-moe-a2.7b;
    seamless) under each compute path on one streamed export, ``requests``
    requests cold and warm; one 4-slot decode tick traced per path.
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
        counts = serve_run(cfg, s_model, sp, path, requests=requests,
                           profile_ticks=1, wide=False, cold_profile=cold_profile)
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


# phases 4n-4p: the engine's reuse and scheduling features
FEATURE_PREFIX, FEATURE_TAILS = 96, (3, 13)   # shared prefix, tail lengths
FEATURE_REQUESTS, FEATURE_TOKENS = 8, 8


def features_engine(s_model, sp, warm: bool = True, **kw):
    """A 4-slot engine on ``s_model`` (128-token slots; an encoder-decoder
    model's ENC_MAX_LEN ones with ENC_TOKENS-frame encodes), warmed up
    (its ticks then replay CUDA graphs) unless ``warm`` is False."""
    from repro_torch.serve.engine import BatchedEngine, ServeConfig

    cross = s_model.has_cross_attn
    eng = BatchedEngine(s_model, sp, ServeConfig(**{**dict(
        n_slots=N_SLOTS, max_len=ENC_MAX_LEN if cross else 128,
        chunk_tokens=CHUNK, page_tokens=16,
        enc_tokens=ENC_TOKENS if cross else None), **kw}))
    if warm:
        eng.warmup()
    return eng


def feature_prompts(cfg, n: int = FEATURE_REQUESTS, prefix: int = FEATURE_PREFIX):
    """``n`` prompts of one shared ``prefix``-token prefix and a random tail
    of FEATURE_TAILS tokens."""
    import numpy as np

    rng = np.random.default_rng(23)
    shared = rng.integers(0, cfg.vocab, size=prefix)
    return [np.concatenate([shared, rng.integers(
        0, cfg.vocab, size=int(rng.integers(*FEATURE_TAILS)))]).astype(np.int32)
        for _ in range(n)]


def drain_in_turns(eng, turns):
    """Submit each turn's (prompt, params[, frames]) and drain it before the
    next. Returns (requests, ticks, drain seconds, tick end times: the end of
    engine tick i, in drain seconds summed over the turns)."""
    from repro_torch.launch.serve import drain

    reqs, ticks, secs, ends = [], 0, 0.0, []
    for turn in turns:
        reqs += [eng.submit(*job) for job in turn]
        n, dt, tick_ends = drain(eng, reqs[-len(turn):])
        ends += [secs + t for t in tick_ends]
        ticks, secs = ticks + n, secs + dt
    return reqs, ticks, secs, ends


def ttft_ms(reqs, tick_ends):
    """Mean TTFT of ``reqs`` from their submission: in ms (``tick_ends[i]``:
    the end of engine tick i) and in ticks."""
    import numpy as np

    ms = [1e3 * (tick_ends[r.token_steps[0]]
                 - (tick_ends[r.submit_step - 1] if r.submit_step else 0.0))
          for r in reqs]
    return float(np.mean(ms)), float(np.mean([r.token_steps[0] - r.submit_step
                                               for r in reqs]))


def phase_features_granite(cfg, sp):
    """Phase 4n: granite-8b at full width and depth on phase 3's export,
    float, warm engines: the prefix trie (8 requests of one 96-token prefix,
    the first drained alone; hits, skipped tokens, extend ticks and a hit's
    TTFT against the cache-off run, equal tokens), preemption (4 batch
    requests of 64-token prompts, then, 10 ticks later, 2 interactive:
    preempts = resumes,
    per-class TTFT, tokens equal to preempt=False), abort of a live and a
    parked request and abort_all mid-flight (the pool checks out, 0 pages
    in use outside the trie), telemetry on against off (equal tokens, the
    warm decode tick's ms, no eager tick through the warm drains, the trace
    ring's events)."""
    import numpy as np
    import torch

    from repro_torch.configs import build_model
    from repro_torch.nn.context import SERVE, ModelContext
    from repro_torch.serve.engine import TRACE_COUNTS
    from repro_torch.serve.sampling import SamplingParams

    t0 = time.perf_counter()
    s_model = build_model(cfg, ModelContext(policy=cfg.tbn, mode=SERVE,
                                            compute_dtype=torch.bfloat16,
                                            device="cuda"))
    label = f"{cfg.name} float"
    greedy = SamplingParams(max_tokens=FEATURE_TOKENS)
    prompts = feature_prompts(cfg)
    turns = [[(prompts[0], greedy)], [(p, greedy) for p in prompts[1:]]]
    runs, moved = {}, {}
    for name, kw in (("trie", dict(prefix_cache=True, trace_events=256)),
                     ("no trie", dict(prefix_cache=False)),
                     ("no telemetry", dict(prefix_cache=False, telemetry=False))):
        eng = features_engine(s_model, sp, **kw)
        traces = TRACE_COUNTS.copy()
        zero_counters()
        reqs, ticks, dt, ends = drain_in_turns(eng, turns)
        st = eng.stats()
        if TRACE_COUNTS != traces:
            moved[name] = {k: TRACE_COUNTS[k] - traces[k] for k in TRACE_COUNTS}
        runs[name] = dict(tokens=[r.output for r in reqs], st=st, ticks=ticks,
                          counts=read_counters(), ttft=ttft_ms(reqs[1:], ends),
                          hits=[r.prefix_hit_tokens for r in reqs],
                          events=len(eng.tel.ring) if eng.tel and eng.tel.ring else 0)
        if eng.pool is not None:
            eng.pool.check()
            if eng.pool.used_pages != (len(eng.trie.held_pages()) if eng.trie else 0):
                fail(f"{label} {name}: {eng.pool.used_pages} pages in use after the "
                     f"drain, outside the trie")
        del eng
        release()
    on, off, quiet = runs["trie"], runs["no trie"], runs["no telemetry"]
    if moved or any(r["counts"][k] for r in runs.values() for k in r["counts"]):
        fail(f"{label}: a warm drain ran a tick eagerly: TRACE_COUNTS moved "
             f"{moved}, launches {[r['counts'] for r in runs.values()]}")
    if not on["tokens"] == off["tokens"] == quiet["tokens"]:
        fail(f"{label}: greedy tokens differ with the prefix cache or the "
             f"telemetry on and off: {on['tokens'][:2]} / {off['tokens'][:2]} / "
             f"{quiet['tokens'][:2]}")
    hits, skipped = on["st"]["prefix_hits"], on["st"]["prefix_tokens"]
    if hits < FEATURE_REQUESTS - 1 or skipped != FEATURE_PREFIX * hits:
        fail(f"{label}: {hits} prefix hits skipping {skipped} tokens; want >= "
             f"{FEATURE_REQUESTS - 1} hits of {FEATURE_PREFIX} tokens")
    if on["st"]["retraces"] or off["st"]["retraces"] or not on["events"]:
        fail(f"{label}: the eager-tick detector counted {on['st']['retraces']} / "
             f"{off['st']['retraces']}; {on['events']} trace-ring events")
    print(f"serve [{label}] prefix trie, warm: {hits}/{FEATURE_REQUESTS} "
          f"admissions hit, {skipped} of {on['st']['prompt_tokens']} prompt tokens "
          f"skipped, {on['st']['trie_nodes']} trie nodes; extend ticks "
          f"{on['st']['extend_ticks']} (cache off {off['st']['extend_ticks']}), "
          f"ticks {on['ticks']} ({off['ticks']}); the 7 later requests' TTFT mean "
          f"{on['ttft'][0]:.2f} ms, {on['ttft'][1]:.2f} ticks (cache off "
          f"{off['ttft'][0]:.2f} ms, {off['ttft'][1]:.2f} ticks); greedy tokens "
          f"equal on and off", flush=True)
    print(f"serve [{label}] telemetry, warm: decode tick {off['st']['decode_ms_mean']:.3f}"
          f" ms on, {quiet['st']['decode_ms_mean']:.3f} ms off; extend tick "
          f"{off['st']['extend_ms_mean']:.3f} / {quiet['st']['extend_ms_mean']:.3f} ms; "
          f"tokens equal on and off; eager ticks after warmup 0 (no TRACE_COUNTS "
          f"move, no launch through a wrapper); trace ring {on['events']} events; "
          f"latency p50 ttft {on['st']['latency']['ttft_ms']['p50']} ms, itl "
          f"{on['st']['latency']['itl_ms']['p50']} ms (histograms)", flush=True)

    # preemption: 4 batch requests fill the slots, 2 interactive arrive
    rng = np.random.default_rng(5)
    batch = [rng.integers(0, cfg.vocab, size=64).astype(np.int32) for _ in range(4)]
    inter = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32) for n in (9, 14)]
    pre = {}
    for preempt in (True, False):
        eng = features_engine(s_model, sp, priorities=True, preempt=preempt)
        reqs = [eng.submit(p, SamplingParams(max_tokens=24, priority="batch"))
                for p in batch]
        t_run = time.perf_counter()
        ends = []
        for _ in range(10):      # the batch requests are decoding by now
            eng.step()
            ends.append(time.perf_counter() - t_run)
        reqs += [eng.submit(p, SamplingParams(max_tokens=FEATURE_TOKENS,
                                              priority="interactive")) for p in inter]
        eng.run_until_drained(on_tick=lambda _: ends.append(time.perf_counter() - t_run))
        st = eng.stats()
        pre[preempt] = dict(tokens=[r.output for r in reqs], st=st,
                            ttft={c: ttft_ms([r for r in reqs if r.priority == c],
                                             ends)[0]
                                  for c in ("batch", "interactive")})
        eng.pool.check()
        if eng.pool.used_pages:
            fail(f"{label} preempt={preempt}: {eng.pool.used_pages} pages in use")
        del eng
        release()
    st = pre[True]["st"]
    if pre[True]["tokens"] != pre[False]["tokens"]:
        fail(f"{label}: greedy tokens differ with preemption on and off")
    if not st["resumes"] == st["preempts"] >= 1:
        fail(f"{label}: {st['preempts']} preempts, {st['resumes']} resumes")
    print(f"serve [{label}] preemption, warm: {st['preempts']} preempts, "
          f"{st['resumes']} resumes, {st['preempted_tokens']} context tokens parked; "
          f"TTFT interactive {st['class_ttft_ticks']['interactive']} ticks / "
          f"{pre[True]['ttft']['interactive']:.1f} ms, batch "
          f"{st['class_ttft_ticks']['batch']} ticks / {pre[True]['ttft']['batch']:.1f}"
          f" ms (preempt off: interactive "
          f"{pre[False]['st']['class_ttft_ticks']['interactive']} ticks / "
          f"{pre[False]['ttft']['interactive']:.1f} ms, batch "
          f"{pre[False]['st']['class_ttft_ticks']['batch']} ticks / "
          f"{pre[False]['ttft']['batch']:.1f} ms); greedy tokens equal to "
          f"preempt=False", flush=True)

    # abort: one live, one parked, then abort_all mid-flight
    eng = features_engine(s_model, sp, prefix_cache=True, priorities=True,
                          preempt=True)
    finished = []
    eng.on_finish = finished.append
    reqs = [eng.submit(p, SamplingParams(max_tokens=24)) for p in prompts[:6]]
    for _ in range(3):
        eng.step()
    live = list(eng._live)
    eng.abort(eng._live[live[0]])
    parked = eng._live[live[1]]
    eng.preempt_slot(live[1])
    eng.abort(parked)
    for _ in range(2):
        eng.step()
    eng.preempt_slot(next(iter(eng._live)))
    n = eng.abort_all()
    eng.pool.check()
    outside = eng.pool.used_pages - len(eng.trie.held_pages())
    eng.trie.clear()
    eng.pool.check()
    if (outside or eng.pool.used_pages or eng.has_work or len(finished) != len(reqs)
            or not all(r.done for r in reqs)):
        fail(f"{label} abort: {outside} pages in use outside the trie, "
             f"{eng.pool.used_pages} after clearing it, {len(finished)} of "
             f"{len(reqs)} finished")
    print(f"serve [{label}] abort: one live and one parked request aborted, then "
          f"abort_all ended {n} (live, parked, queued); on_finish fired "
          f"{len(finished)} times for {len(reqs)} requests; KVPool.check() passes, "
          f"0 pages in use outside the trie", flush=True)
    del eng
    release()
    print(f"phase 4n ({cfg.name} engine features): {time.perf_counter() - t0:.1f}s",
          flush=True)


# phase 4q: the HTTP shell's workload (phase 3's prompts and tokens), the
# stagger between stream starts, and the long request the shutdown holds
HTTP_HOST, HTTP_STAGGER_S, HTTP_SHUFFLE_SEED = "127.0.0.1", 0.005, 24
HTTP_HOLD_AFTER, HTTP_LONG_TOKENS = 3, 64


def serve_cli_http(timeout: float = 240.0):
    """The serve CLI's HTTP mode on the card, as a subprocess: the readiness
    line, one 4-token stream, /stats, /metrics, one [stats] line, then SIGINT
    with a connection open that never sends its request. Returns (seconds to
    the readiness line, seconds from SIGINT to exit, the CLI's output)."""
    import asyncio
    import queue
    import signal
    import socket
    import threading

    from repro_torch.serve.client import request_json, request_text, sse_generate

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "granite-8b",
         "--reduced", "--serve", "--port", "0", "--stats-interval", "0.5"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=str(ROOT))
    lines: "queue.Queue" = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                              daemon=True)
    reader.start()
    seen = []

    def next_line(pred, what: str):
        while True:
            try:
                line = lines.get(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
            except queue.Empty:
                fail(f"serve CLI --serve: no {what} within {timeout:.0f}s:\n"
                     + "".join(seen)[-3000:])
            seen.append(line)
            if pred(line):
                return line

    try:
        ready = next_line(lambda ln: ln.startswith("serving on http://"),
                          "readiness line")
        boot = time.perf_counter() - t0
        if not ready.strip().endswith("(aot=on)"):
            fail(f"serve CLI --serve: readiness line {ready.strip()!r} without "
                 f"(aot=on)")
        port = int(ready.split(":")[2].split()[0])

        async def go():
            st, ev, _ = await sse_generate(HTTP_HOST, port, {
                "prompt": [1, 2, 3], "max_tokens": 4})
            return (st, ev, await request_json(HTTP_HOST, port, "GET", "/stats"),
                    await request_text(HTTP_HOST, port, "GET", "/metrics"))
        st, ev, (_, stats), (mst, mtext) = asyncio.run(go())
        if (st != 200 or sum("token" in e for e in ev) != 4
                or ev[-1].get("finish_reason") != "length"
                or stats.get("aot_warm") is not True or stats.get("retraces")
                or mst != 200 or "serve_tick_seconds_count" not in mtext):
            fail(f"serve CLI --serve: stream {st} {ev}, stats aot_warm "
                 f"{stats.get('aot_warm')} retraces {stats.get('retraces')}, "
                 f"/metrics {mst}")
        next_line(lambda ln: ln.startswith("[stats]"), "[stats] line")
        # a connection that never sends its request: the graceful stop cuts
        # it after ServerConfig.drain_timeout instead of waiting on it
        silent = socket.create_connection((HTTP_HOST, port))
        time.sleep(0.2)
        t_sig = time.perf_counter()
        proc.send_signal(signal.SIGINT)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            fail("serve CLI --serve: still serving 60 s after SIGINT with a "
                 "silent connection open")
        stop_s = time.perf_counter() - t_sig
        silent.close()
        reader.join(10)
        while not lines.empty():
            seen.append(lines.get())
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = "".join(seen)
    if rc != 0 or "server closed" not in out or "Traceback" in out:
        fail(f"serve CLI --serve exit {rc} after SIGINT:\n{out[-3000:]}")
    return boot, stop_s, out


def phase_http_granite(cfg, sp):
    """Phase 4q: granite-8b at full width and depth on phase 3's export,
    float, served through the HTTP/SSE shell (see the module docstring)."""
    import asyncio

    import numpy as np
    import torch

    from repro_torch.configs import build_model
    from repro_torch.launch.serve import synthetic_prompts
    from repro_torch.nn.context import SERVE, ModelContext
    from repro_torch.serve.client import request_json, request_text, sse_generate
    from repro_torch.serve.detok import PieceCodec, decode_all
    from repro_torch.serve.engine import TRACE_COUNTS
    from repro_torch.serve.server import EngineServer, ServerConfig
    from repro_torch.serve.testing import hold_after, read_to_eof, sse_until

    t0 = time.perf_counter()
    label = f"{cfg.name} float"
    s_model = build_model(cfg, ModelContext(policy=cfg.tbn, mode=SERVE,
                                            compute_dtype=torch.bfloat16,
                                            device="cuda"))
    prompts = synthetic_prompts(np.random.default_rng(0), 8, cfg.vocab, 3, 101)
    max_tokens = 16
    eng = serve_engine(s_model, sp, "float")
    eng.warmup()
    drained = drive(eng, cfg, prompts, max_tokens)
    del eng
    release()

    eng = serve_engine(s_model, sp, "float")
    srv = EngineServer(eng, ServerConfig(host=HTTP_HOST, port=0))
    order = [int(i) for i in np.random.default_rng(HTTP_SHUFFLE_SEED).permutation(8)]

    async def streams():
        port = await srv.start(aot=True)
        traces = TRACE_COUNTS.copy()
        zero_counters()
        try:
            async def one(i, k):
                await asyncio.sleep(HTTP_STAGGER_S * k)
                t_send = time.perf_counter()
                return i, t_send, await sse_generate(HTTP_HOST, port, {
                    "prompt": [int(t) for t in prompts[i]],
                    "max_tokens": max_tokens})
            got = await asyncio.gather(*(one(i, k) for k, i in enumerate(order)))
            single = await request_json(HTTP_HOST, port, "POST", "/generate", {
                "prompt": [int(t) for t in prompts[0]], "max_tokens": max_tokens,
                "stream": False})
            counts = read_counters()
            metrics = await request_text(HTTP_HOST, port, "GET", "/metrics")
            return got, single, metrics, srv.stats(), counts, TRACE_COUNTS == traces
        finally:
            await srv.close()

    got, single, (mst, mtext), st, counts, still = asyncio.run(streams())
    codec = PieceCodec()
    ttft, itl, by_req = [], [], {}
    for i, t_send, (status, events, times) in got:
        toks = [e["token"] for e in events if "token" in e]
        text = "".join(e["text"] for e in events if "token" in e)
        done = events[-1]
        if (status != 200 or toks != drained["tokens"][i]
                or done.get("finish_reason") != "length"
                or not text == done["text"] == decode_all(codec, toks)):
            fail(f"{label} HTTP: stream of request {i} gave status {status}, "
                 f"tokens {toks} (drain {drained['tokens'][i]}), final {done}")
        tok_times = [t for e, t in zip(events, times) if "token" in e]
        by_req[i] = 1e3 * (tok_times[0] - t_send)
        ttft.append(by_req[i])
        itl += [1e3 * (b - a) for a, b in zip(tok_times, tok_times[1:])]
    s_stream = next(ev for i, _, (_, ev, _) in got if i == 0)
    if single[0] != 200 or single[1]["tokens"] != [e["token"] for e in s_stream
                                                   if "token" in e]:
        fail(f"{label} HTTP: the non-streaming request gave {single}")
    gen_count = [ln for ln in mtext.splitlines() if ln.startswith(
        'serve_http_request_seconds_count{route="/generate"}')]
    tick_count = [ln for ln in mtext.splitlines()
                  if ln.startswith("serve_tick_seconds_count")]
    if (st["retraces"] or not still or any(counts.values()) or mst != 200
            or not tick_count or int(tick_count[0].split()[-1]) <= 0
            or not gen_count or int(gen_count[0].split()[-1]) != len(prompts) + 1):
        fail(f"{label} HTTP: retraces {st['retraces']}, TRACE_COUNTS unchanged "
             f"{still}, launches {counts}, /metrics {mst} {tick_count} {gen_count}")

    # mid-flight shutdown: a new server on the same warm engine (warmup() is
    # then a no-op), one long request held live after its 3rd token
    srv = EngineServer(eng, ServerConfig(host=HTTP_HOST, port=0))
    held = hold_after(srv, HTTP_HOLD_AFTER)

    async def shutdown():
        port = await srv.start(aot=True)
        reader, writer, events, buf = await sse_until(HTTP_HOST, port, {
            "prompt": [int(t) for t in prompts[1]],
            "max_tokens": HTTP_LONG_TOKENS}, HTTP_HOLD_AFTER)
        try:
            await srv.close()
            return await read_to_eof(reader, buf, events)
        finally:
            writer.close()

    events = asyncio.run(shutdown())
    toks = [e for e in events if "token" in e]
    done = events[-1]
    outside = eng.pool.used_pages - (len(eng.trie.held_pages()) if eng.trie else 0)
    eng.pool.check()
    if (not held.is_set() or done.get("finish_reason") != "aborted"
            or len(toks) != HTTP_HOLD_AFTER
            or done["text"] != "".join(e["text"] for e in toks)
            or srv.detok.alive or srv._tick_thread.is_alive()
            or srv._tick_error is not None or eng.stats()["live_slots"]
            or outside):
        fail(f"{label} HTTP close mid-flight: {len(toks)} token events, final "
             f"{done}; detok alive {srv.detok.alive}, tick alive "
             f"{srv._tick_thread.is_alive()}, error {srv._tick_error!r}, live "
             f"{eng.stats()['live_slots']}, {outside} pages outside the trie")
    del srv, eng
    release()
    boot, stop_s, out = serve_cli_http()

    card = card_line()
    dst = drained["st"]
    print(f"serve [{label}] HTTP/SSE shell, warm, on {card}: 8 streams "
          f"(shuffled, {1e3 * HTTP_STAGGER_S:.0f} ms apart, 16 greedy tokens) "
          f"equal to the warm in-process drain, text = decode_all, one "
          f"non-streaming request = its stream; retraces 0, no TRACE_COUNTS move, "
          f"no launch through a wrapper; /metrics tick count "
          f"{tick_count[0].split()[-1]}, /generate {gen_count[0].split()[-1]}",
          flush=True)
    print(f"serve [{label}] HTTP client vs in-process drain: TTFT mean "
          f"{np.mean(ttft):.2f} ms p50 {np.median(ttft):.2f} ms (drain "
          f"{drained['ttft']:.2f} / {drained['ttft_p50']:.2f}) | ITL mean "
          f"{np.mean(itl):.2f} ms p50 {np.median(itl):.2f} ms (drain "
          f"{drained['itl']:.2f} / {drained['itl_p50']:.2f}) | warm decode tick "
          f"in the server {st['decode_ms_mean']:.3f} ms, drain "
          f"{dst['decode_ms_mean']:.3f} ms; extend tick {st['extend_ms_mean']:.3f}"
          f" / {dst['extend_ms_mean']:.3f} ms | detok backlog peak "
          f"{st['detok_backlog_peak']}", flush=True)
    drain_ttft = {r: 1e3 * drained["tick_ends"][q.token_steps[0]]
                  for r, q in enumerate(drained["reqs"])}
    print(f"serve [{label}] HTTP TTFT per request (client / drain, ms): "
          + ", ".join(f"{i}: {by_req[i]:.1f} / {drain_ttft[i]:.1f}"
                      for i in sorted(by_req)), flush=True)
    print(f"serve [{label}] HTTP close mid-flight: held after {HTTP_HOLD_AFTER} "
          f"tokens, final event aborted with their text, both threads joined, "
          f"0 live slots, 0 pages outside the trie, KVPool.check() passes",
          flush=True)
    print(f"serve CLI --serve (--arch granite-8b --reduced, card): ready in "
          f"{boot:.1f}s (aot=on), one stream, /stats, /metrics, [stats], SIGINT "
          f"with a silent connection open -> exit 0 in {stop_s:.1f}s, server "
          f"closed", flush=True)
    print(f"phase 4q ({cfg.name} HTTP shell): {time.perf_counter() - t0:.1f}s",
          flush=True)


def phase_features_mamba(cfg, sp):
    """Phase 4o: mamba2-370m at full width and MAMBA_SERVE_LAYERS on 4h's
    export, float, warm: the prefix trie with the slot snapshot and restore
    captured; 4 requests of one 64-token prefix (the first drained alone):
    the hits restore through the replayed graph (no eager tick, no
    TRACE_COUNTS move), tokens equal to the cache-off run, and the bytes
    the trie's snapshots hold."""
    import torch

    from repro_torch.configs import build_model
    from repro_torch.nn.context import SERVE, ModelContext
    from repro_torch.serve.engine import TRACE_COUNTS
    from repro_torch.serve.sampling import SamplingParams

    t0 = time.perf_counter()
    s_model = build_model(cfg, ModelContext(policy=cfg.tbn, mode=SERVE,
                                            compute_dtype=torch.bfloat16,
                                            device="cuda"))
    label = f"{cfg.name} float"
    greedy = SamplingParams(max_tokens=FEATURE_TOKENS)
    prompts = feature_prompts(cfg, 4, 64)
    turns = [[(prompts[0], greedy)], [(p, greedy) for p in prompts[1:]]]
    runs = {}
    for on in (True, False):
        eng = features_engine(s_model, sp, prefix_cache=on)
        timings = eng._warm_s
        traces = TRACE_COUNTS.copy()
        zero_counters()
        reqs, ticks, dt, ends = drain_in_turns(eng, turns)
        counts = read_counters()
        if TRACE_COUNTS != traces or any(counts.values()):
            fail(f"{label} prefix_cache={on}: the warm drain ran a tick eagerly: "
                 f"TRACE_COUNTS {dict(traces)} -> {dict(TRACE_COUNTS)}, {counts}")
        torch.cuda.synchronize()
        runs[on] = dict(tokens=[r.output for r in reqs], st=eng.stats(),
                        timings=dict(timings), ticks=ticks, dt=dt)
        del eng
        release()
    st = runs[True]["st"]
    if runs[True]["tokens"] != runs[False]["tokens"]:
        fail(f"{label}: greedy tokens differ with the prefix cache on and off")
    if (not {"snapshot_slot", "restore_slot"} <= set(runs[True]["timings"])
            or st["prefix_hits"] < 3 or st["retraces"]):
        fail(f"{label}: warmup {sorted(runs[True]['timings'])}, "
             f"{st['prefix_hits']} hits, {st['retraces']} eager ticks")
    print(f"serve [{label}] prefix trie, warm: snapshot_slot "
          f"{runs[True]['timings']['snapshot_slot']:.3f}s and restore_slot "
          f"{runs[True]['timings']['restore_slot']:.3f}s captured; {st['prefix_hits']}"
          f"/4 admissions hit, {st['prefix_tokens']} prompt tokens skipped; the "
          f"warm drain with its restores moved no TRACE_COUNTS and launched "
          f"nothing through a wrapper; extend ticks {st['extend_ticks']} (cache off "
          f"{runs[False]['st']['extend_ticks']}), {runs[True]['dt']:.2f}s "
          f"({runs[False]['dt']:.2f}s); {st['trie_nodes']} trie nodes hold "
          f"{st['trie_snapshot_bytes'] / 1e6:.1f} MB of snapshots; greedy tokens "
          f"equal on and off", flush=True)
    print(f"phase 4o ({cfg.name} prefix trie): {time.perf_counter() - t0:.1f}s",
          flush=True)


def phase_features_seamless(cfg, sp):
    """Phase 4p: seamless-m4t-large-v2 at full width and depth on 4k's
    export, float, cold engines: 8 requests over 2 source clips; 2 encode
    ticks with the EncoderCache, 8 without, equal greedy tokens."""
    import numpy as np
    import torch

    from repro_torch.configs import build_model
    from repro_torch.launch.serve import synthetic_prompts
    from repro_torch.nn.context import SERVE, ModelContext
    from repro_torch.serve.sampling import SamplingParams

    t0 = time.perf_counter()
    s_model = build_model(cfg, ModelContext(policy=cfg.tbn, mode=SERVE,
                                            compute_dtype=torch.bfloat16,
                                            device="cuda"))
    label = f"{cfg.name} float"
    rng = np.random.default_rng(3)
    clips = synthetic_frames(cfg, rng, 2)
    prompts = synthetic_prompts(rng, FEATURE_REQUESTS, cfg.vocab)
    runs = {}
    for on in (True, False):
        eng = features_engine(s_model, sp, warm=False, prefix_cache=on)
        reqs, ticks, dt, _ = drain_in_turns(eng, [[
            (p, SamplingParams(max_tokens=FEATURE_TOKENS), clips[i % 2])
            for i, p in enumerate(prompts)]])
        st = eng.stats()
        runs[on] = dict(tokens=[r.output for r in reqs], st=st, ticks=ticks, dt=dt)
        eng.xpool.check()
        held = len(eng.enc_cache.held_pages()) if eng.enc_cache else 0
        if eng.xpool.used_pages != held:
            fail(f"{label}: {eng.xpool.used_pages} cross pages in use, {held} "
                 f"held by the EncoderCache")
        del eng
        release()
    on, off = runs[True], runs[False]
    if on["tokens"] != off["tokens"]:
        fail(f"{label}: greedy tokens differ with the EncoderCache on and off")
    if (on["st"]["encode_ticks"], off["st"]["encode_ticks"]) != (2, FEATURE_REQUESTS):
        fail(f"{label}: {on['st']['encode_ticks']} encode ticks with the "
             f"EncoderCache and {off['st']['encode_ticks']} without; want 2 and "
             f"{FEATURE_REQUESTS}")
    print(f"serve [{label}] EncoderCache, cold: {FEATURE_REQUESTS} requests over 2 "
          f"sources ({len(clips[0])} and {len(clips[1])} frames): "
          f"{on['st']['encode_ticks']} encode ticks and {on['st']['enc_cache_hits']} "
          f"cache hits ({off['st']['encode_ticks']} encode ticks without), "
          f"{on['ticks']} ticks in {on['dt']:.2f}s ({off['ticks']} in "
          f"{off['dt']:.2f}s); greedy tokens equal on and off", flush=True)
    print(f"phase 4p ({cfg.name} EncoderCache): {time.perf_counter() - t0:.1f}s",
          flush=True)


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
    """Phases 4d, 4f and 4l: ``arch`` at its published width and depth (or
    ``n_layers``), float path, 4 requests of 8 greedy tokens, through the
    same counter checks, ``profile_ticks`` decode ticks traced cold and
    warm. Returns (params, launch counts)."""
    import torch

    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    s_model, sp, _ = build_on_card(cfg)
    counts = serve_run(cfg, s_model, sp, "float", requests=4, max_tokens=8,
                       profile_ticks=profile_ticks, wide=False)
    del s_model
    release()
    print(f"phase {phase} ({arch} serve, L={cfg.n_layers}): "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return sp, counts


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
    published width and depth (mamba2: MAMBA_SERVE_LAYERS) under each
    compute path, as phase 4b, with
    no page pool and the slot reset among the captured entry points; for
    recurrentgemma-2b then the window-wrapping request (:func:`wrap_run`).
    Returns (params, launch counts)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if arch == MAMBA:
        cfg = dataclasses.replace(cfg, n_layers=MAMBA_SERVE_LAYERS)
    # mamba2's cold profiles (each a cold per-token extend tick first) went
    # when phases 4k-4m made the run longer
    sp, launches = phase_serve_paths(cfg, phase, cold_profile=arch != MAMBA)
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
    from repro_torch.roofline import hw
    from repro_torch.roofline.analysis import kernel_terms

    hwc = hw.card(card)  # data-sheet peaks by the nvidia-smi name
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
            work = kernel_terms("B5", w.shape, None, w.dtype, with_a=a is not None)
            nbytes = work.bytes
            res = dict(err=err, ms=time_ms(lambda: kernel(w, a)),
                       plain_ms=time_ms(lambda: tile_construct_plain(w, a)),
                       bound_ms=work.bound_ms(hwc)[0])
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


def phase_train_remat(cfg, card: str):
    """Phase 5d: one fused step of phase 5's model (granite-8b at full width,
    TRAIN_LAYERS layers, f32 masters of seed 0, bf16 compute, AdamW as
    ``build_training`` wires it) on phase 5's first batch under each remat
    policy, from the same masters: the loss, the launches (counters zeroed
    just before, read just after), the state's bytes (masters and both
    moments, summed ``nbytes``) and the step's peak of device memory
    (``max_memory_allocated`` with the state allocated, the peak reset just
    before; the bytes allocated before the step that are not the state's
    are taken off). Then a forward + backward alone on REMAT_BATCH x
    TRAIN_SEQ rows: its peak above what was allocated before it and its
    launches. "dots" must give "full"'s loss within rtol REPLAY_RTOL,
    launch B2 as often as "none" (its products are saved) and less often
    than "full", and the forward + backward peaks must fall strictly:
    none > dots > full. Returns {remat: measurements} for the dry-run
    phase."""
    import torch

    from repro_torch.configs import build_model
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.nn import module as mod
    from repro_torch.nn.context import TRAIN, ModelContext
    from repro_torch.optim import adamw, cosine_with_warmup
    from repro_torch.train.step import build_train_step, init_state

    t0 = time.perf_counter()
    L = TRAIN_LAYERS
    batch = lm_batch(0, 0, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab)
    wide = {k: v.to("cuda") for k, v in
            lm_batch(0, 1, REMAT_BATCH, TRAIN_SEQ, cfg.vocab).items()}
    out = {}
    for remat in REMAT_MODES:
        model = build_model(dataclasses.replace(cfg, n_layers=L, remat=remat),
                            ModelContext(policy=cfg.tbn, mode=TRAIN,
                                         compute_dtype=torch.bfloat16,
                                         device="cuda", fused_train=True))
        opt = adamw(cosine_with_warmup(3e-4, 2, 8), weight_decay=0.1)
        state = init_state(model.init(0), opt)
        step_fn = build_train_step(model.train_forward, opt)
        state_bytes = sum(v.numel() * v.element_size() for tree in (
            state.params, state.opt_state.mu, state.opt_state.nu)
            for _, v in mod.walk(tree))
        release()
        torch.cuda.synchronize()
        other = torch.cuda.memory_allocated() - state_bytes
        torch.cuda.reset_peak_memory_stats()
        zero_counters()
        state, m = step_fn(state, batch)
        loss = float(m["loss"])
        counts = read_counters()
        peak = torch.cuda.max_memory_allocated() - other
        # forward + backward alone, on the updated masters
        leaves = [v.requires_grad_(True) for _, v in mod.walk(state.params)]
        del m
        release()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        zero_counters()
        # (the aux is dropped at once: its graph would hold the masters
        # past this mode's run)
        fb_loss = model.train_forward(state.params, wide)[0]
        grads = torch.autograd.grad(fb_loss, leaves)
        torch.cuda.synchronize()
        fb_counts = read_counters()
        fb_peak = torch.cuda.max_memory_allocated() - before
        fb_loss = float(fb_loss.detach())
        del grads, leaves
        out[remat] = dict(loss=loss, counts=counts, state_bytes=state_bytes,
                          peak=peak, fb_peak=fb_peak, fb_counts=fb_counts)
        print(f"phase 5d [remat={remat}, granite-8b full width, L={L}, fused, bf16, "
              f"{card}]: step 1 ({TRAIN_BATCH}x{TRAIN_SEQ}) loss {loss:.5f}; "
              f"launches B5 = {counts['B5']}, B2 = {counts['B2']}; state (masters "
              f"+ 2 AdamW moments) {state_bytes} B; step peak {peak / 1e9:.3f} GB "
              f"(max_memory_allocated less {other / 1e6:.1f} MB held before the "
              f"step); forward + backward alone ({REMAT_BATCH}x{TRAIN_SEQ}) loss "
              f"{fb_loss:.5f}, launches B5 = {fb_counts['B5']}, B2 = "
              f"{fb_counts['B2']}, peak {fb_peak / 1e9:.3f} GB above the "
              f"{before / 1e9:.3f} GB held before it", flush=True)
        del model, state, step_fn, opt
        release()
    none, full, dots = (out[k] for k in REMAT_MODES)
    if abs(dots["loss"] - full["loss"]) > REPLAY_RTOL * abs(full["loss"]):
        fail(f"phase 5d: remat=dots loss {dots['loss']} vs full {full['loss']} "
             f"(rtol {REPLAY_RTOL})")
    want = {"none": (7 * L + 1, 7 * L + 1), "full": (14 * L + 1, 14 * L + 1),
            "dots": (14 * L + 1, 7 * L + 1)}
    for remat, (b5, b2) in want.items():
        for what in ("counts", "fb_counts"):
            c = out[remat][what]
            if (c["B5"], c["B2"]) != (b5, b2) or any(c[k] for k in ("B1", "B3", "B4", "B6")):
                fail(f"phase 5d remat={remat} ({what}): launches {c}; need B5 = "
                     f"{b5}, B2 = {b2}")
    if not none["fb_peak"] > dots["fb_peak"] > full["fb_peak"]:
        fail(f"phase 5d: forward + backward peaks none {none['fb_peak']} > dots "
             f"{dots['fb_peak']} > full {full['fb_peak']} does not hold")
    print(f"phase 5d (remat none / full / dots, {card}): dots loss within "
          f"{abs(dots['loss'] - full['loss']) / abs(full['loss']):.2e} of full's; "
          f"B2 launches {none['counts']['B2']} / {full['counts']['B2']} / "
          f"{dots['counts']['B2']} (dots saves B2's products: 7 L + 1 against 14 L "
          f"+ 1), B5 {none['counts']['B5']} / {full['counts']['B5']} / "
          f"{dots['counts']['B5']} (B5 recomputed under dots); step peaks "
          f"{none['peak'] / 1e9:.3f} / {full['peak'] / 1e9:.3f} / "
          f"{dots['peak'] / 1e9:.3f} GB (AdamW's, one figure); forward + backward "
          f"peaks at {REMAT_BATCH}x{TRAIN_SEQ} {none['fb_peak'] / 1e9:.3f} / "
          f"{full['fb_peak'] / 1e9:.3f} / {dots['fb_peak'] / 1e9:.3f} GB (none > "
          f"dots > full holds); {time.perf_counter() - t0:.1f}s", flush=True)
    return out


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


def check_conv(x, packed, kw, card):
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
    from repro_torch.roofline.analysis import kernel_terms

    n, _, _, c = x.shape
    (oh, ow), r = kw["out_hw"], packed.shape[1]
    bank = unpack_conv_tile(packed, r, c, 3, 3, dtype=x.dtype)
    x_nchw = x.permute(0, 3, 1, 2)          # channels-last view: cuDNN NHWC
    m = n * oh * ow
    work = kernel_terms("B6", x.shape, packed.shape, x.dtype, out_hw=kw["out_hw"])
    t_bytes, t_ops = work.times_ms(card)
    res = dict(err=err, scale=scale, flops=work.ops,
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
    from repro_torch.roofline import hw

    hwc = hw.card(card)  # data-sheet peaks by the nvidia-smi name
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    results = {}
    for name, h, c, r, stride, _ in CONV_SHAPES:
        for n in CONV_NS:
            for dtype in (torch.bfloat16, torch.float32):
                x, packed, kw = conv_operands(n, h, c, r, stride, dtype, gen)
                res = check_conv(x, packed, kw, hwc)
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


# --------------------------------------------------------------------------
# phase 4r: tensor- and expert-parallel serving under a ("data", "model")
# mesh of ranks that share cuda:0 over gloo
# --------------------------------------------------------------------------
def tp_cut(sp, n_layers: int):
    """``sp`` cut to its first ``n_layers`` layers (every stacked segment
    leaf's leading axis; views, no copy)."""
    from repro_torch.nn import module as mod

    return {k: mod.map_tree(lambda v: v[:n_layers], v) if k.startswith("seg")
            else v for k, v in sp.items()}


def tp_save(name: str, sp, n_layers=None) -> None:
    """Keep ``sp`` for phase 4r on the host in TP_DIR, cut to its first
    ``n_layers`` layers if given."""
    import torch

    from repro_torch.nn import module as mod

    sp = tp_cut(sp, n_layers) if n_layers else sp
    torch.save(mod.map_tree(lambda v: v.cpu(), sp), TP_DIR / f"{name}.pt")


def tp_load(name: str):
    """A tree that :func:`tp_save` kept, on cuda:0."""
    import torch

    return torch.load(TP_DIR / f"{name}.pt", map_location="cuda", weights_only=True)


@contextlib.contextmanager
def counting_plain(counts: dict):
    """Within the block, every call of a kernel's plain version (B1-B4, B6)
    adds one to ``counts[name]``: on card tensors a wrapper launches its
    kernel or raises, and this shows no plain version ran instead."""
    from repro_torch.kernels import tiled_conv, tiled_matmul, tiled_matvec, tiled_xnor

    spots = [(tiled_matvec, "tiled_matvec_plain"), (tiled_matmul, "tiled_matmul_plain"),
             (tiled_xnor, "xnor_matvec_words"), (tiled_xnor, "int8_matvec_packed"),
             (tiled_conv, "tiled_conv_plain")]
    saved = [(m, n, getattr(m, n)) for m, n in spots]

    def counted(name, fn):
        def run(*a, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **kw)
        return run

    for m, n, fn in saved:
        setattr(m, n, counted(n, fn))
    try:
        yield counts
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def tp_models(cfg, n_layers: int, dtype, paths=tuple(PATH_KERNEL)):
    """{path: SERVE model} of ``cfg`` cut to ``n_layers`` on cuda:0."""
    from repro_torch.configs import build_model
    from repro_torch.nn.context import SERVE, ModelContext

    cut = dataclasses.replace(cfg, n_layers=n_layers)
    return {p: build_model(cut, ModelContext(policy=cfg.tbn, mode=SERVE,
                                             compute_dtype=dtype, device="cuda",
                                             compute_path=p)) for p in paths}


def tp_logits(model, sp, mesh=None):
    """Prefill of TP_PROMPT, then TP_DECODE_STEPS greedy decode steps (under
    the mesh's rules with a mesh); the logits of each call on the CPU."""
    import torch

    from repro_torch.distributed.sharding import axis_rules

    rules = axis_rules(mesh) if mesh is not None else contextlib.nullcontext()
    with torch.no_grad(), rules:
        lg, c, lens = model.prefill(sp, {"tokens": torch.tensor(
            [TP_PROMPT], device="cuda")}, 64)
        out = [lg.cpu()]
        for _ in range(TP_DECODE_STEPS):
            lg, c, lens = model.decode_step(sp, lg.argmax(-1)[:, None], c, lens)
            out.append(lg.cpu())
    return out


def tp_engine(model, sp, mesh=None):
    """A cold engine of phase 3's shape (under ``mesh``: this rank's)."""
    from repro_torch.serve.engine import BatchedEngine, ServeConfig

    return BatchedEngine(model, sp, ServeConfig(
        n_slots=N_SLOTS, max_len=128, chunk_tokens=CHUNK, page_tokens=16,
        compute_path=model.ctx.compute_path), mesh=mesh)


def tp_drain(model, sp, cfg, prompts, max_tokens: int, mesh=None):
    """A cold engine of phase 3's shape over ``prompts`` (greedy), with the
    launch counters zeroed just before the drain and read just after, and
    every plain version counted. Returns (tokens, token steps, launches,
    plain calls)."""
    from repro_torch.serve.sampling import SamplingParams

    eng = tp_engine(model, sp, mesh)
    reqs = [eng.submit(p, SamplingParams(max_tokens=max_tokens)) for p in prompts]
    plain = {}
    zero_counters()
    with counting_plain(plain):
        eng.run_until_drained()
    counts = read_counters()
    if not all(r.done and len(r.output) == max_tokens for r in reqs):
        fail(f"{cfg.name}: not every request finished with {max_tokens} tokens")
    return [r.output for r in reqs], [r.token_steps for r in reqs], counts, plain


def tp_tick_ms(eng, timed_gathers: bool = False):
    """Median ms of TP_TIMED_TICKS cold decode ticks of an engine, after one
    more (every slot inactive: the work of a 4-slot tick, and no state
    moves), each synchronized;
    with ``timed_gathers`` also the share of them spent in the tiled layers'
    gathers (each gather synchronized before and after)."""
    import torch

    from repro_torch.kernels import ops

    spent = [0.0]
    gather = ops.gather_blocks

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gather(*a, **kw)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        return out

    times = []
    eng._active_t.zero_()
    if timed_gathers:
        ops.gather_blocks = timed
    try:
        with torch.no_grad(), eng._mesh_ctx():
            for _ in range(TP_TIMED_TICKS + 1):
                torch.cuda.synchronize()
                spent[0] = 0.0
                t0 = time.perf_counter()
                eng._tick("decode_tick")
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0, spent[0]))
    finally:
        ops.gather_blocks = gather
    times = times[1:]
    tick = statistics.median(t for t, _ in times)
    share = sum(g for _, g in times) / sum(t for t, _ in times)
    return 1e3 * tick, share


def tp_shard_kernels(placed, mesh_label: str):
    """Each per-shard tile of a granite layer (layer 0's q, k, v, o, gate,
    up, down and the head, r/TP rows each) through B1 (m = 4), B2 (m = 128),
    B3 and B4 (m = 4) against the plain versions on the same card inputs,
    at phase 2's tolerances (B3 / B4: equal). Returns the checks made."""
    import torch

    from repro_torch.kernels.tiled_matmul import tiled_matmul_plain
    from repro_torch.kernels.tiled_matvec import tiled_matvec_plain
    from repro_torch.kernels.tiled_xnor import (
        int8_matvec_packed,
        quantize_int8,
        quantize_sign,
        xnor_matvec_words,
    )
    from repro_torch.nn import module as mod

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    ks = kernels()
    n = 0
    for path, leaf in mod.walk(placed):
        if path[-1] != "tile":
            continue
        packed = leaf[0] if path[0].startswith("seg") else leaf
        k = packed.shape[1] * 32
        name = "/".join(path[:-1])
        for kname, m, plain in (("B1", 4, tiled_matvec_plain),
                                ("B2", 128, tiled_matmul_plain)):
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            got, want = ks[kname](x, packed), plain(x, packed)
            if not torch.allclose(got, want, rtol=RTOL,
                                  atol=RTOL * float(want.abs().max())):
                fail(f"{mesh_label} {name}: {kname} per shard ({tuple(packed.shape)}) "
                     f"max|err| {float((got - want).abs().max()):.3e}")
            n += 1
        x = torch.randn((4, k), generator=gen, device="cuda").to(torch.bfloat16)
        a, _ = quantize_sign(x, k)
        q, _ = quantize_int8(x, k)
        for kname, got, want in (
                ("B3", ks["B3"](a, packed, n_in=k), xnor_matvec_words(a, packed, n_in=k)),
                ("B4", ks["B4"](q, packed), int8_matvec_packed(q, packed, n_in=k))):
            if not torch.equal(got, want):
                fail(f"{mesh_label} {name}: {kname} per shard ({tuple(packed.shape)}) "
                     f"int32 accumulator differs from the plain version")
            n += 1
    return n


def tp_rank_main(job_dir: str) -> None:
    """One rank of a phase 4r job (``chip_smoke.py --tp-rank JOB_DIR`` with
    RANK and WORLD_SIZE set): joins the gloo job through a FileStore in the
    job directory on cuda:0, builds the job's mesh, serves each part of the
    job under it and saves the results to rank<i>.pt there."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import place_params
    from repro_torch.nn import module as mod
    from repro_torch.serve.weights import per_device_tile_bytes

    global TP_DIR
    TP_DIR = Path(job_dir).parent
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.cuda.set_device(0)
    job = torch.load(Path(job_dir) / "job.pt", weights_only=False)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(Path(job_dir) / "store"), world), rank=rank, world_size=world)
    mesh = init_device_mesh("cuda", tuple(job["mesh"]), mesh_dim_names=("data", "model"))
    label = f"rank {rank} of mesh {job['mesh']}"
    out = {"seconds": {}}
    t0 = time.perf_counter()

    def lap(what):
        nonlocal t0
        out["seconds"][what] = time.perf_counter() - t0
        t0 = time.perf_counter()

    granite = get_config("granite-8b")
    full = tp_load("granite")
    model = tp_models(granite, granite.n_layers, torch.float32, ("float",))["float"]
    placed = place_params(full, mod.logical_axes(model.specs()), mesh)
    lap("load")
    out["tile_bytes"] = per_device_tile_bytes(placed, mesh)
    out["shard_checks"] = tp_shard_kernels(placed, label)
    out["logits"] = tp_logits(model, placed, mesh)
    sp = tp_cut(full, TP_LAYERS)
    del full, placed, model
    lap("checks")
    models = tp_models(granite, TP_LAYERS, torch.float32)
    for path, model in models.items():
        tokens, steps, counts, plain = tp_drain(model, sp, granite, job["prompts"],
                                                TP_MAX_TOKENS, mesh)
        out[path] = dict(tokens=tokens, steps=steps, counts=counts, plain=plain)
        lap(path)
    if "bf16" in job["parts"]:
        model = tp_models(granite, TP_LAYERS, torch.bfloat16, ("float",))["float"]
        eng = tp_engine(model, sp, mesh)
        out["bf16_tick_ms"] = tp_tick_ms(eng)[0]
        out["bf16_gather_share"] = tp_tick_ms(eng, timed_gathers=True)[1]
        del eng
        lap("bf16")
    del sp, models
    if "moe" in job["parts"]:
        moe = get_config(MOE)
        msp = tp_load("moe")
        model = tp_models(moe, TP_MOE_LAYERS, torch.float32, ("float",))["float"]
        mplaced = place_params(msp, mod.logical_axes(model.specs()), mesh)
        out["moe_logits"] = tp_logits(model, mplaced, mesh)
        tokens, _, counts, plain = tp_drain(model, msp, moe, job["prompts"],
                                            TP_MAX_TOKENS, mesh)
        out["moe"] = dict(tokens=tokens, counts=counts, plain=plain,
                          experts_held=int(mplaced["seg0"]["ffn"]["up"]["tile"].shape[1]))
        del mplaced
        lap("moe")
        del msp, model
    if "r34" in job["parts"]:
        from repro_torch.distributed.sharding import axis_rules

        _, sms, _, _ = resnet34_models(torch.float32)
        sp34 = tp_load("r34")
        placed = place_params(sp34, mod.logical_axes(sms["cuda"].specs()), mesh)
        x = torch.load(TP_DIR / "r34_x.pt", map_location="cuda")
        with axis_rules(mesh):
            y, _, counts = r34_forwards(sms["cuda"], placed, x, 1)
        out["r34"] = dict(logits=y.cpu(), counts=counts)
        lap("r34")
    torch.save(out, Path(job_dir) / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def tp_job(dims, parts, prompts):
    """Run a phase 4r job on prod(dims) ranks of this script sharing cuda:0;
    returns each rank's results and the job's wall seconds."""
    import torch

    job_dir = TP_DIR / f"job{dims[0]}x{dims[1]}"
    job_dir.mkdir()
    torch.save(dict(mesh=dims, parts=parts, prompts=prompts), job_dir / "job.pt")
    world = dims[0] * dims[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), WORLD_SIZE=str(world),
               OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--tp-rank",
                               str(job_dir)], env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for r, p in enumerate(procs):
            try:
                outs.append(p.communicate(timeout=TP_JOB_TIMEOUT)[0])
            except subprocess.TimeoutExpired:
                fail(f"phase 4r mesh {dims}: rank {r} still running after "
                     f"{TP_JOB_TIMEOUT}s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode:
            fail(f"phase 4r mesh {dims}: rank {r} exited {p.returncode}:\n{text[-3000:]}")
    return ([torch.load(job_dir / f"rank{r}.pt", weights_only=False)
             for r in range(world)], time.perf_counter() - t0)


def tp_close(label: str, got, want, tol: float) -> float:
    """The largest |got - want| of a list of logits, failing past
    ``tol`` * max|want| (or on a non-finite value)."""
    import torch

    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        err = float((g - w).abs().max())
        worst = max(worst, err / float(w.abs().max()))
        if not torch.isfinite(g).all() or err > tol * float(w.abs().max()):
            fail(f"{label}: call {i} logits max|diff| {err:.3e} over "
                 f"{tol} * max|logit| {float(w.abs().max()):.3e}")
    return worst


def tp_mesh_cli_start():
    """Start the serve CLI under torch.distributed.run, 2 ranks on the card:
    ``--arch granite-8b --reduced --mesh 1x2``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve", "--arch",
         "granite-8b", "--reduced", "--mesh", "1x2", "--requests", "4",
         "--max-tokens", "8"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=str(ROOT))


def tp_mesh_cli_finish(started, card: str):
    """Wait for the CLI of :func:`tp_mesh_cli_start`: exit 0, the gloo
    backend and 2.0x sharding of the tile bits."""
    t0, proc = started
    try:
        text, err = proc.communicate(timeout=TP_JOB_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"serve CLI --mesh 1x2 still running after {TP_JOB_TIMEOUT}s")
    dt = time.perf_counter() - t0
    if (proc.returncode != 0 or "backend=gloo" not in text
            or "(2.0x sharding)" not in text or "Traceback" in err):
        fail(f"serve CLI --mesh 1x2 exit {proc.returncode}:\n{text[-2000:]}\n"
             f"{err[-2000:]}")
    line = next(ln for ln in text.splitlines() if "backend=" in ln)
    print(f"serve CLI --mesh 1x2 (--arch granite-8b --reduced, 2 ranks sharing one "
          f"card, {card}; beside the (2, 2) job): exit 0 in {dt:.1f}s; {line.strip()}; "
          + next(ln for ln in text.splitlines() if "sharding" in ln).strip(), flush=True)


def phase_tp(card: str, sp34):
    """Phase 4r: the exports of phases 3, 4e and 9 (granite-8b whole, its
    engines cut to TP_LAYERS; qwen2-moe-a2.7b cut to TP_MOE_LAYERS;
    ResNet-34 whole) served by 2 and then 4 ranks that share cuda:0 over
    gloo, against the single card on the same exports. Returns the tile
    bytes each rank of the (1, 2) job held ({rank: bytes})."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import synthetic_prompts
    from repro_torch.serve.weights import tile_serving_bytes

    t0 = time.perf_counter()
    granite, moe = get_config("granite-8b"), get_config(MOE)
    prompts = synthetic_prompts(np.random.default_rng(0), 8, granite.vocab, 3, 101)
    # the single card's references on the same exports, f32
    full = tp_load("granite")
    total_tile = tile_serving_bytes(full)
    model = tp_models(granite, granite.n_layers, torch.float32, ("float",))["float"]
    ref = {"logits": tp_logits(model, full)}
    sp = tp_cut(full, TP_LAYERS)
    del full, model
    models = tp_models(granite, TP_LAYERS, torch.float32)
    for path, model in models.items():
        tokens, steps, counts, _ = tp_drain(model, sp, granite, prompts, TP_MAX_TOKENS)
        ref[path] = dict(tokens=tokens, steps=steps, counts=counts)
    model = tp_models(granite, TP_LAYERS, torch.bfloat16, ("float",))["float"]
    eng = tp_engine(model, sp)
    ref["bf16_tick_ms"] = tp_tick_ms(eng)[0]
    del sp, models, model, eng
    msp = tp_load("moe")
    model = tp_models(moe, TP_MOE_LAYERS, torch.float32, ("float",))["float"]
    ref["moe_logits"] = tp_logits(model, msp)
    ref["moe"] = dict(zip(("tokens", "steps", "counts"), tp_drain(
        model, msp, moe, prompts, TP_MAX_TOKENS)[:3]))
    del msp, model
    _, sms, _, _ = resnet34_models(torch.float32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    x = torch.randn((2, 224, 224, 3), generator=gen, device="cuda")
    torch.save(x.cpu(), TP_DIR / "r34_x.pt")
    tp_save("r34", sp34)
    ref["r34"], _, _ = r34_forwards(sms["cuda"], sp34, x, 1)
    ref["r34"] = ref["r34"].cpu()
    del sms, x
    release()
    t_ref = time.perf_counter() - t0
    print(f"phase 4r single-card references (granite-8b L={granite.n_layers} "
          f"logits, L={TP_LAYERS} engines; {MOE} L={TP_MOE_LAYERS}, f32; resnet34 "
          f"N=2): {t_ref:.1f}s", flush=True)

    cli = None
    for dims, parts in ((TP_MESHES[0], ("bf16", "moe", "r34")), (TP_MESHES[1], ())):
        if not parts:       # the CLI runs beside the job that times nothing
            cli = tp_mesh_cli_start()
        ranks, dt = tp_job(dims, parts, prompts)
        tp = dims[1]
        label = f"mesh {dims} ({len(ranks)} ranks sharing one card, {card})"
        for r, res in enumerate(ranks):
            who = f"{label} rank {r}"
            worst = tp_close(f"{who} granite-8b L={granite.n_layers} f32", res["logits"],
                             ref["logits"], TP_LOGIT_RTOL)
            for path in PATH_KERNEL:
                got, want = res[path], ref[path]
                if (got["tokens"], got["steps"]) != (want["tokens"], want["steps"]):
                    fail(f"{who} {path}: engine tokens differ from the single card's: "
                         f"{got['tokens'][:2]} vs {want['tokens'][:2]}")
                if got["counts"] != want["counts"] or got["plain"]:
                    fail(f"{who} {path}: launches {got['counts']} (single card "
                         f"{want['counts']}), plain versions run {got['plain']}")
            per_rank = res["tile_bytes"]
            if len(per_rank) != len(ranks) or any(
                    v * tp != total_tile for v in per_rank.values()):
                fail(f"{who}: tile bytes per rank {per_rank} x TP={tp} != "
                     f"{total_tile}")
            if dims == (1, 2):
                tile_rank = per_rank
            if "moe" in parts:
                mw = tp_close(f"{who} {MOE} L={TP_MOE_LAYERS} f32", res["moe_logits"],
                              ref["moe_logits"], TP_LOGIT_RTOL)
                got = res["moe"]
                if (got["tokens"] != ref["moe"]["tokens"]
                        or got["counts"] != ref["moe"]["counts"] or got["plain"]
                        or got["experts_held"] != moe.moe.n_experts // tp):
                    fail(f"{who} {MOE}: tokens {got['tokens'][:2]} vs "
                         f"{ref['moe']['tokens'][:2]}, launches {got['counts']} vs "
                         f"{ref['moe']['counts']}, plain {got['plain']}, "
                         f"{got['experts_held']} experts held")
            if "r34" in parts:
                y, counts = res["r34"]["logits"], res["r34"]["counts"]
                err = r34_err = float((y - ref["r34"]).abs().max())
                if (counts["B6"] != 18 or counts["B1"] != 1
                        or not torch.allclose(y, ref["r34"], rtol=TP_R34_TOL,
                                              atol=TP_R34_TOL)):
                    fail(f"{who} resnet34 N=2: logits max|diff| {err:.3e}, "
                         f"launches {counts}")
        res = ranks[0]
        print(f"phase 4r [{label}]: {res['shard_checks']} per-shard kernel checks "
              f"a rank (B1/B2 at rtol=1e-4, B3/B4 equal); granite-8b (full width, "
              f"L={granite.n_layers}, f32) prefill + {TP_DECODE_STEPS} decode logits "
              f"within {worst:.2e} x max|logit| of the single card; engine tokens "
              f"(L={TP_LAYERS}, 8 x {TP_MAX_TOKENS} greedy) equal under float / xnor / "
              f"int8 with each "
              f"rank's launches equal to the single card's ("
              + ", ".join(f"{p} {ref[p]['counts'][k]} {k}"
                          for p, k in PATH_KERNEL.items())
              + f"), no plain version run; tile bytes {total_tile / 1e6:.3f} MB, "
              f"{max(res['tile_bytes'].values()) / 1e6:.3f} MB a rank "
              f"({total_tile / max(res['tile_bytes'].values()):.1f}x); job {dt:.1f}s "
              f"(rank 0: " + ", ".join(f"{k} {v:.1f}s" for k, v in res["seconds"].items())
              + ")", flush=True)
        if "moe" in parts:
            print(f"phase 4r [{label}]: {MOE} (full width, L={TP_MOE_LAYERS}, f32, "
                  f"{moe.moe.n_experts // tp} of {moe.moe.n_experts} experts a rank) "
                  f"logits within {mw:.2e} x max|logit|, tokens equal, launches "
                  f"{res['moe']['counts']}; resnet34 N=2 f32 logits max|diff| "
                  f"{r34_err:.2e} (rtol=atol={TP_R34_TOL}; B6 per shard, 18 launches "
                  f"a rank)",
                  flush=True)
        if "bf16" in parts:
            print(f"phase 4r [{label}]: cold bf16 decode tick (granite-8b full width, "
                  f"L={TP_LAYERS}, {N_SLOTS} slots, median of {TP_TIMED_TICKS}) "
                  f"{res['bf16_tick_ms']:.2f} ms on the mesh against "
                  f"{ref['bf16_tick_ms']:.2f} ms on one card; the gathers take "
                  f"{res['bf16_gather_share']:.3f} of a tick (each synchronized; "
                  f"information, not a multi-card figure)", flush=True)
    tp_mesh_cli_finish(cli, card)
    print(f"phase 4r (TP/EP serving, ranks sharing one card): "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return tile_rank


# ---------------------------------------------------------------------------
# phase 5r: training under a mesh
# ---------------------------------------------------------------------------
def train_mesh_model(cfg, fused: bool = True):
    """granite-8b cut to TRAIN_MESH_LAYERS, TRAIN mode, bf16 compute, fused
    (B5 + B2), on cuda:0."""
    import torch

    from repro_torch.configs import build_model
    from repro_torch.nn.context import TRAIN, ModelContext

    cut = dataclasses.replace(cfg, n_layers=TRAIN_MESH_LAYERS)
    return build_model(cut, ModelContext(policy=cfg.tbn, mode=TRAIN,
                                         compute_dtype=torch.bfloat16,
                                         device="cuda", fused_train=fused,
                                         fsdp_weights=cfg.fsdp_weights))


def train_moe_model(cfg):
    """qwen2-moe-a2.7b cut to TP_MOE_LAYERS, TRAIN mode, bf16 compute, fused
    (B5 + B2 for its attention, shared experts and head), on cuda:0."""
    import torch

    from repro_torch.configs import build_model
    from repro_torch.nn.context import TRAIN, ModelContext

    cut = dataclasses.replace(cfg, n_layers=TP_MOE_LAYERS)
    return build_model(cut, ModelContext(policy=cfg.tbn, mode=TRAIN,
                                         compute_dtype=torch.bfloat16,
                                         device="cuda", fused_train=True))


def placed_masters(model, shards, mesh):
    """This rank's blocks of ``model.init(0)``, built one whole leaf at a
    time (a rank never holds the whole masters)."""
    from repro_torch.distributed.sharding import master_block
    from repro_torch.nn import module as mod

    out: dict = {}
    for path, spec in mod.walk(model.specs()):
        leaf = mod.init_leaf(spec, 0, path, model.device)
        mod.set_path(out, path, master_block(leaf, mod.get_path(shards, path), mesh))
        del leaf
    return out


def plain_sgd(lr: float):
    """SGD without momentum (p -= lr * g in place): no state but the step."""
    import torch

    from repro_torch.nn import module as mod
    from repro_torch.optim.adamw import Optimizer

    @torch.no_grad()
    def update(grads, step, params):
        for path, v in mod.walk(params):
            v.sub_(lr * mod.get_path(grads, path).to(v.dtype))
        return params, step + 1

    return Optimizer(init=lambda params: 0, update=update)


def train_mesh_batch(cfg, step: int):
    from repro_torch.data.synthetic import lm_batch

    return lm_batch(0, step, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab)


def train_mesh_reckon(model, dims, card_bytes: int) -> dict:
    """Each rank's bytes under mesh ``dims``: the masters it holds (a tiled
    Dense's r/TP rows, every other leaf whole), its gradients and two AdamW
    moments of the same size, the whole masters it builds once before it
    cuts them, and the activations of its TRAIN_BATCH / DP rows (the
    remat'd blocks' inputs, one block's recompute, the bf16 logits of a
    loss chunk and the f32 (m, d) gradient of a Dense's input)."""
    from repro_torch.nn import module as mod

    cfg = model.cfg
    whole = held = 0
    for _, spec in mod.walk(model.specs()):
        n = math.prod(spec.shape) * 4
        whole += n
        held += n // dims[1] if spec.tile_p else n
    rows = TRAIN_BATCH // dims[0] * TRAIN_SEQ
    acts = (rows * cfg.d_model * 2 * (cfg.n_layers + 8)
            + rows * cfg.d_ff * 2 * 4 + rows * cfg.vocab * 2 * 2
            + rows * max(cfg.d_model, cfg.d_ff) * 4)
    state = 4 * held
    per_rank = state + whole + acts
    ranks = dims[0] * dims[1]
    return dict(held=held, whole=whole, state=state, acts=acts,
                per_rank=per_rank, total=per_rank * ranks,
                fits=per_rank * ranks <= 0.9 * card_bytes)


@contextlib.contextmanager
def timing_collectives(out: dict):
    """Within the block, every collective of torch.distributed (all_reduce,
    all_gather, broadcast, barrier) is timed with the card synchronized
    before and after, into ``out["s"]`` and ``out["n"]``, and counted by
    kind (the dry run's names) into ``out["kinds"]``."""
    import torch
    import torch.distributed as dist

    names = {"all_reduce": "all-reduce", "all_gather": "all-gather",
             "broadcast": "broadcast", "barrier": "barrier"}
    saved = {n: getattr(dist, n) for n in names}
    out.setdefault("s", 0.0)
    out.setdefault("n", 0)
    out.setdefault("kinds", {})

    def timed_call(fn, kind):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = fn(*a, **kw)
            torch.cuda.synchronize()
            out["s"] += time.perf_counter() - t
            out["n"] += 1
            out["kinds"][kind] = out["kinds"].get(kind, 0) + 1
            return res
        return run

    for n, fn in saved.items():
        setattr(dist, n, timed_call(fn, names[n]))
    try:
        yield out
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)


@contextlib.contextmanager
def counting_all_plain(counts: dict):
    """``counting_plain`` with B5's plain version counted too."""
    import importlib

    tile_construct = importlib.import_module("repro_torch.kernels.tile_construct")

    saved = tile_construct.tile_construct_plain

    def counted(*a, **kw):
        counts["tile_construct_plain"] = counts.get("tile_construct_plain", 0) + 1
        return saved(*a, **kw)

    tile_construct.tile_construct_plain = counted
    try:
        with counting_plain(counts):
            yield counts
    finally:
        tile_construct.tile_construct_plain = saved


def train_probe(model, params, shards, mesh=None):
    """The B5 words and whole alpha of layer 0's FFN gate as this rank (or
    one card) builds them from its masters."""
    import torch

    from repro_torch.distributed.sharding import sum_over
    from repro_torch.kernels.ops import _rows_spec, tile_construct

    w = params["seg0"]["ffn"]["gate"]["w"][0].detach()
    spec = model.ctx.policy.spec_for((model.cfg.d_ff, model.cfg.d_model),
                                     kind="dense")
    words, alpha = tile_construct(w, _rows_spec(spec, w))
    shard = None if shards is None else shards["seg0"]["ffn"]["gate"]["w"]
    if shard is not None and shard.rows:
        tp = math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in shard.rows)
        alpha = sum_over(alpha, mesh, shard.rows) / tp
    torch.cuda.synchronize()
    return words.cpu(), alpha.cpu()


def train_mesh_steps(model, step_fn, state):
    """TRAIN_MESH_STEPS steps with the launch counters zeroed just before and
    read just after and every plain version counted; the last step is
    timed with its collectives timed (the card synchronized around each).
    Returns (losses, clip norms, counts, plain, ms of the last step,
    collectives' seconds, calls and calls by kind in it, final state)."""
    import torch

    cfg = model.cfg
    losses, gnorms, plain, coll = [], [], {}, {}
    zero_counters()
    with counting_all_plain(plain):
        for i in range(TRAIN_MESH_STEPS):
            last = i == TRAIN_MESH_STEPS - 1
            with timing_collectives(coll) if last else contextlib.nullcontext():
                torch.cuda.synchronize()
                t = time.perf_counter()
                state, m = step_fn(state, train_mesh_batch(cfg, i))
                losses.append(float(m["loss"]))
                ms = 1e3 * (time.perf_counter() - t)
                gnorms.append(float(m["grad_norm"]))
    counts = read_counters()
    return (losses, gnorms, counts, plain, ms, coll.get("s", 0.0), coll.get("n", 0),
            coll.get("kinds", {}), state)


def update_leaf(path) -> bool:
    return "/".join(path).startswith(TRAIN_MESH_UPDATE_LEAVES)


def train_update_error(params, model, shards, mesh, ref_path) -> float:
    """The worst leaf's ||d - d_1|| / ||d_1|| over this rank's block of the
    TRAIN_MESH_UPDATE_LEAVES: d the update the steps made to its params
    (after - ``model.init(0)``), d_1 one card's (saved at ``ref_path``)."""
    import torch

    from repro_torch.distributed.sharding import master_block, place_train_params
    from repro_torch.nn import module as mod

    init = place_train_params(model.init(0), shards, mesh)
    ref = torch.load(ref_path, weights_only=True)
    worst = 0.0
    for path, d1 in mod.walk(ref):
        p = mod.get_path(params, path)
        d1 = master_block(d1, mod.get_path(shards, path), mesh).to(p.device)
        d = p.detach().float() - mod.get_path(init, path).float()
        num, den = float((d - d1).norm()), float(d1.norm())
        worst = max(worst, num / den if den else num)
    return worst


def train_mesh_rank_main(job_dir: str) -> None:
    """One rank of a phase 5r job (``chip_smoke.py --train-rank JOB_DIR``
    with RANK and WORLD_SIZE set): joins the gloo job through a FileStore
    on cuda:0 and trains under each of the job's meshes, then the job's
    extra parts (the EF-sign step, the GPipe check, the checkpoint);
    saves the results to rank<i>.pt there."""
    import hashlib

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import (
        gather_train_params, place_train_params, train_shards)
    from repro_torch.nn import module as mod
    from repro_torch.optim import adamw
    from repro_torch.train.step import build_train_step, init_state

    torch.backends.cuda.matmul.allow_tf32 = False
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.cuda.set_device(0)
    job = torch.load(Path(job_dir) / "job.pt", weights_only=False)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(Path(job_dir) / "store"), world), rank=rank, world_size=world)
    granite = get_config("granite-8b")
    # a job started early (its start-up beside the job before it) waits
    # for its go before it touches the card
    while not (Path(job_dir) / "go").exists():
        time.sleep(0.05)
    out = {"seconds": {}}
    t0 = time.perf_counter()

    def lap(what):
        nonlocal t0
        out["seconds"][what] = time.perf_counter() - t0
        t0 = time.perf_counter()

    lap("start")
    for dims in job["meshes"]:
        tag = f"{dims[0]}x{dims[1]}"
        mesh = init_device_mesh("cuda", tuple(dims), mesh_dim_names=("data", "model"))
        model = train_mesh_model(granite)
        shards = train_shards(model.specs(), mesh, fsdp=granite.fsdp_weights)
        params = place_train_params(model.init(0), shards, mesh)
        torch.cuda.empty_cache()
        words, alpha = train_probe(model, params, shards, mesh)
        opt = adamw(TRAIN_MESH_LR)
        step_fn = build_train_step(model.train_forward, opt, mesh=mesh, shards=shards)
        state = init_state(params, opt)
        held = sum(v.numel() * v.element_size() for _, v in mod.walk(params))
        lap(f"{tag} set-up")
        losses, gnorms, counts, plain, ms, coll_s, coll_n, kinds, state = (
            train_mesh_steps(model, step_fn, state))
        peak = torch.cuda.max_memory_allocated()
        params = state.params
        del state       # the moments go before the update is read
        torch.cuda.empty_cache()
        update_err = train_update_error(params, model, shards, mesh,
                                        Path(job_dir).parent / "train_ref_update.pt")
        out[tuple(dims)] = dict(
            words=words, alpha=alpha, model_index=mesh.get_local_rank("model"),
            losses=losses, gnorms=gnorms, update_err=update_err, counts=counts,
            plain=plain, step_ms=ms, coll_s=coll_s, coll_n=coll_n, kinds=kinds,
            held=held, peak=peak)
        del model, params, step_fn, opt
        torch.cuda.empty_cache()
        lap(f"{tag} steps")
    if "moe" in job["parts"]:
        moe = get_config(MOE)
        for dims in (d for d in MOE_TRAIN_MESHES if d[0] * d[1] == world):
            mesh = init_device_mesh("cuda", dims, mesh_dim_names=("data", "model"))
            model = train_moe_model(moe)
            shards = train_shards(model.specs(), mesh)
            params = placed_masters(model, shards, mesh)
            opt = plain_sgd(TRAIN_MESH_LR)
            step_fn = build_train_step(model.train_forward, opt, mesh=mesh,
                                       shards=shards)
            state = init_state(params, opt)
            held = sum(v.numel() * v.element_size() for _, v in mod.walk(params))
            experts = int(params["seg0"]["ffn"]["up"]["w"].shape[1])
            torch.cuda.reset_peak_memory_stats()
            losses, gnorms, counts, plain, ms, coll_s, coll_n, kinds, state = (
                train_mesh_steps(model, step_fn, state))
            out[("moe", dims)] = dict(
                losses=losses, gnorms=gnorms, counts=counts, plain=plain,
                step_ms=ms, coll_s=coll_s, coll_n=coll_n, kinds=kinds, held=held,
                experts=experts, peak=torch.cuda.max_memory_allocated())
            del model, params, state, step_fn, opt
            torch.cuda.empty_cache()
            lap(f"moe {dims[0]}x{dims[1]}")
    if "ef_sign" in job["parts"]:
        from repro_torch.distributed.compression import (
            CompressionState, build_dp_train_step)

        mesh = init_device_mesh("cuda", (2, 1), mesh_dim_names=("data", "model"))
        model = train_mesh_model(granite)
        params, opt = model.init(0), adamw(TRAIN_MESH_LR)
        step = build_dp_train_step(model.train_forward, opt, mesh, compression="ef_sign")
        state, comp = init_state(params, opt), CompressionState.init(params, "ef_sign")
        state, comp, m = step(state, comp, train_mesh_batch(granite, 0))
        out["ef_sign"] = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))
        del model, params, state, comp, opt, step
        torch.cuda.empty_cache()
        lap("ef_sign")
    if "gpipe" in job["parts"]:
        from repro_torch.distributed.pipeline import build_gpipe_apply
        from repro_torch.launch.mesh import make_stage_mesh

        stages = make_stage_mesh(world, "cuda")
        model = train_mesh_model(granite)
        seg = model.segments[0]
        stacked = {k: v for k, v in model.init(0)["seg0"].items()}
        stacked = mod.map_tree(lambda v: v.requires_grad_(True), stacked)
        positions = torch.arange(GPIPE_SEQ, device="cuda")[None].expand(GPIPE_MB, -1)

        def stage_fn(pl, h):
            return seg.block(pl, h, positions=positions)[0]

        gen = torch.Generator(device="cuda")
        gen.manual_seed(7)
        x = torch.randn((GPIPE_MICRO, GPIPE_MB, GPIPE_SEQ, granite.d_model),
                        generator=gen, device="cuda").to(torch.bfloat16)
        zero_counters()
        y = build_gpipe_apply(stage_fn, stages)(stacked, x)
        y.float().square().sum().backward()
        counts = read_counters()
        s = stages.get_local_rank("stage")
        grads = mod.map_tree(lambda v: v.grad[s].float().clone(), stacked)
        mod.map_tree(lambda v: setattr(v, "grad", None), stacked)
        ys = []
        for i in range(GPIPE_MICRO):        # the stages in sequence, one rank
            h = x[i]
            for j in range(world):
                h = stage_fn(mod.map_tree(lambda v: v[j], stacked), h)
            ys.append(h)
        y_ref = torch.stack(ys)
        y_ref.float().square().sum().backward()
        worst_g = 0.0
        for path, g in mod.walk(grads):
            g_ref = mod.get_path(stacked, path).grad[s].float()
            scale = float(g_ref.abs().max()) or 1.0
            worst_g = max(worst_g, float((g - g_ref).abs().max()) / scale)
        out["gpipe"] = dict(
            y_err=float((y.float() - y_ref.float()).abs().max())
            / float(y_ref.float().abs().max()),
            g_err=worst_g, finite=bool(torch.isfinite(y).all()), counts=counts,
            stage=s)
        del model, stacked, grads, y, y_ref, ys
        torch.cuda.empty_cache()
        lap("gpipe")
    if "ckpt" in job["parts"]:
        from repro_torch.launch.train import build_training

        mesh = init_device_mesh("cuda", tuple(job["meshes"][0]),
                                mesh_dim_names=("data", "model"))
        small = granite.reduced()
        model = train_mesh_model(small)
        tr = build_training(small, model.ctx, seed=0, batch=4, seq=64, lr=1e-3,
                            warmup=1, total_steps=3, grad_accum=1,
                            ckpt_dir=str(Path(job_dir) / "ckpt"), ckpt_every=2,
                            mesh=mesh)
        final = tr.recovery.run(tr.step_fn, 3)
        digests = {}
        for name, tree in (("params", final.params), ("mu", final.opt_state.mu),
                           ("nu", final.opt_state.nu)):
            whole = gather_train_params(tree, tr.shardings.shards, mesh)
            for path, v in mod.walk(whole):
                digests[f"{name}/{'/'.join(path)}"] = hashlib.sha256(
                    v.detach().cpu().numpy().tobytes()).hexdigest()
        out["ckpt"] = dict(digests=digests, step=final.step,
                           restarts=tr.recovery.restarts)
        lap("ckpt")
    torch.save(out, Path(job_dir) / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def train_mesh_job_start(dims_list, parts, world: int, go: bool = True):
    """Start a phase 5r job on ``world`` ranks of this script sharing
    cuda:0; its ranks start training once the job's go file exists
    (written now unless ``go`` is False: ``train_mesh_job_go``)."""
    import torch

    job_dir = TP_DIR / f"train{world}"
    job_dir.mkdir()
    torch.save(dict(meshes=dims_list, parts=parts), job_dir / "job.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), WORLD_SIZE=str(world),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                               "--train-rank", str(job_dir)],
                              env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    started = dict(dir=job_dir, procs=procs, dims=dims_list, t0=time.perf_counter())
    if go:
        train_mesh_job_go(started)
    return started


def train_mesh_job_go(started) -> None:
    started["t0"] = time.perf_counter()
    (started["dir"] / "go").write_text("go")


def train_mesh_job_finish(started):
    """Each rank's results of a started job and the seconds from its go."""
    import torch

    procs, dims_list = started["procs"], started["dims"]
    outs = []
    try:
        for r, p in enumerate(procs):
            try:
                outs.append(p.communicate(timeout=TP_JOB_TIMEOUT)[0])
            except subprocess.TimeoutExpired:
                fail(f"phase 5r job {dims_list}: rank {r} still running after "
                     f"{TP_JOB_TIMEOUT}s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode:
            fail(f"phase 5r job {dims_list}: rank {r} exited {p.returncode}:\n"
                 f"{text[-3000:]}")
    return ([torch.load(started["dir"] / f"rank{r}.pt", weights_only=False)
             for r in range(len(procs))], time.perf_counter() - started["t0"])


def train_cli_mesh_start():
    """Start the train CLI under torch.distributed.run, 2 ranks on the card:
    ``--arch granite-8b --reduced --steps 3 --mesh 1x2``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", "--arch",
         "granite-8b", "--reduced", "--steps", "3", "--mesh", "1x2",
         "--ckpt-dir", str(TP_DIR / "train_cli")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=str(ROOT))


def train_cli_mesh_finish(started, card: str) -> None:
    t0, proc = started
    try:
        text, err = proc.communicate(timeout=TP_JOB_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"train CLI --mesh 1x2 still running after {TP_JOB_TIMEOUT}s")
    if (proc.returncode != 0 or text.count("done: 3 steps") != 1
            or "backend=gloo" not in text):
        fail(f"train CLI --mesh 1x2 exit {proc.returncode}:\n{text[-2000:]}\n"
             f"{err[-2000:]}")
    done = next(ln for ln in text.splitlines() if ln.startswith("done:"))
    print(f"train CLI --mesh 1x2 (--arch granite-8b --reduced, 2 ranks sharing one "
          f"card, {card}; beside the (2, 2) job): exit 0 in "
          f"{time.perf_counter() - t0:.1f}s; {done.strip()}", flush=True)


def phase_train_mesh(card: str) -> dict:
    """Phase 5r: granite-8b training at full width cut to TRAIN_MESH_LAYERS,
    fused, under (1, 2), (2, 1) and (2, 2) on ranks sharing cuda:0 over
    gloo, against one card on the same masters; the EF-sign DP step, a
    2-stage GPipe of full-width blocks, a checkpoint written under (2, 2)
    restored onto one card, and the train CLI under --mesh."""
    import hashlib

    import torch

    from repro_torch.configs import get_config
    from repro_torch.ft.recovery import elastic_restore
    from repro_torch.nn import module as mod
    from repro_torch.optim import adamw
    from repro_torch.train.step import build_train_step, init_state

    t_phase = time.perf_counter()
    granite = get_config("granite-8b")
    L = TRAIN_MESH_LAYERS
    per_step = 2 * 7 * L + 1
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    # the single card's reference: the same masters, batches and optimizer
    model = train_mesh_model(granite)
    for dims in (dims for job in TRAIN_MESH_JOBS for dims in job):
        rk = train_mesh_reckon(model, dims, card_bytes)
        print(f"phase 5r memory reckoning, mesh {dims}: a rank holds "
              f"{rk['held'] / 1e9:.3f} GB of masters (one card "
              f"{rk['whole'] / 1e9:.3f}); masters + grads + 2 AdamW moments "
              f"{rk['state'] / 1e9:.3f} GB, the whole masters built once before "
              f"the cut {rk['whole'] / 1e9:.3f} GB, activations ~"
              f"{rk['acts'] / 1e9:.3f} GB: {rk['per_rank'] / 1e9:.3f} GB a rank, "
              f"{rk['total'] / 1e9:.3f} GB for {dims[0] * dims[1]} ranks of "
              f"{card_bytes / 1e9:.1f} GB (must leave 10%)", flush=True)
        if not rk["fits"]:
            fail(f"phase 5r mesh {dims}: {rk['total'] / 1e9:.1f} GB reckoned over 90% "
                 f"of the card")
    params = model.init(0)
    ref_words, ref_alpha = train_probe(model, params, None)
    opt = adamw(TRAIN_MESH_LR)
    ref_losses, ref_gnorms, ref_counts, _, ref_ms, _, _, _, state = train_mesh_steps(
        model, build_train_step(model.train_forward, opt), init_state(params, opt))
    if ref_counts["B5"] != TRAIN_MESH_STEPS * per_step:
        fail(f"phase 5r single card: launches {ref_counts}")
    params = state.params
    del state
    # the update one card's steps made, for the ranks to read their blocks of
    update: dict = {}
    for path, v in mod.walk(model.init(0)):
        if update_leaf(path):
            mod.set_path(update, path, (mod.get_path(params, path).detach() - v).cpu())
    torch.save(update, TP_DIR / "train_ref_update.pt")
    del model, params, update, opt
    release()
    print(f"phase 5r single card (granite-8b full width, L={L}, fused, bf16, "
          f"{TRAIN_BATCH}x{TRAIN_SEQ}): losses "
          + " ".join(f"{v:.5f}" for v in ref_losses)
          + ", clip norms " + " ".join(f"{v:.6f}" for v in ref_gnorms)
          + f", step {TRAIN_MESH_STEPS} {ref_ms:.1f} ms; {time.perf_counter() - t_phase:.1f}s",
          flush=True)

    # the MoE jobs' one-card reference: the same masters, batches and SGD
    moe = get_config(MOE)
    model = train_moe_model(moe)
    opt = plain_sgd(TRAIN_MESH_LR)
    moe_losses, moe_gnorms, moe_counts, _, moe_ms, _, _, _, state = train_mesh_steps(
        model, build_train_step(model.train_forward, opt),
        init_state(model.init(0), opt))
    if moe_counts["B5"] != TRAIN_MESH_STEPS * per_step:
        fail(f"phase 5r {MOE} single card: launches {moe_counts}")
    del model, state, opt
    release()
    print(f"phase 5r single card ({MOE} full width, L={TP_MOE_LAYERS}, "
          f"{moe.moe.n_experts} experts, fused, bf16, {TRAIN_BATCH}x{TRAIN_SEQ}, "
          f"SGD {TRAIN_MESH_LR}): losses " + " ".join(f"{v:.5f}" for v in moe_losses)
          + ", clip norms " + " ".join(f"{v:.6f}" for v in moe_gnorms)
          + f", step {TRAIN_MESH_STEPS} {moe_ms:.1f} ms", flush=True)

    # both jobs start now; the second trains once the first has ended (its
    # ranks' start-up runs beside the first job), with the CLI beside it
    jobs = [train_mesh_job_start(list(dims_list), PARTS_5R[i],
                                 dims_list[0][0] * dims_list[0][1], go=i == 0)
            for i, dims_list in enumerate(TRAIN_MESH_JOBS)]
    cli, mesh_results = None, {}
    for i, (dims_list, job) in enumerate(zip(TRAIN_MESH_JOBS, jobs)):
        parts, world = PARTS_5R[i], len(job["procs"])
        if i:
            train_mesh_job_go(job)
            cli = train_cli_mesh_start()
        ranks, dt = train_mesh_job_finish(job)
        for dims in dims_list:
            label = f"mesh {dims} ({world} ranks sharing one card, {card})"
            want = TRAIN_MESH_STEPS * per_step
            for r, res in enumerate(ranks):
                got = res[dims]
                tp = dims[1]
                n = ref_words.numel() // tp
                t = got["model_index"]
                if not torch.equal(got["words"], ref_words[t * n:(t + 1) * n]):
                    fail(f"{label} rank {r}: B5 words of its rows differ from one "
                         f"card's")
                if not torch.allclose(got["alpha"], ref_alpha, rtol=1e-5, atol=0):
                    fail(f"{label} rank {r}: alpha {got['alpha'][:3]} vs "
                         f"{ref_alpha[:3]}")
                if not all(math.isfinite(v) for v in got["losses"]) or any(
                        abs(a - b) > TRAIN_MESH_RTOL * abs(b)
                        for a, b in zip(got["losses"], ref_losses, strict=True)):
                    fail(f"{label} rank {r}: losses {got['losses']} vs one card's "
                         f"{ref_losses} (rtol {TRAIN_MESH_RTOL})")
                if any(abs(a - b) > TRAIN_MESH_GNORM_RTOL * abs(b)
                       for a, b in zip(got["gnorms"], ref_gnorms, strict=True)):
                    fail(f"{label} rank {r}: clip norms {got['gnorms']} vs one "
                         f"card's {ref_gnorms} (rtol {TRAIN_MESH_GNORM_RTOL})")
                if not got["update_err"] <= TRAIN_MESH_UPDATE_TOL:
                    fail(f"{label} rank {r}: the steps' update of a leaf is "
                         f"{got['update_err']:.3e} (relative, worst leaf) away from "
                         f"one card's (need {TRAIN_MESH_UPDATE_TOL})")
                c = got["counts"]
                if (c["B5"] != want or c["B2"] != want
                        or any(c[k] for k in ("B1", "B3", "B4", "B6")) or got["plain"]):
                    fail(f"{label} rank {r}: launches {c}, plain versions "
                         f"{got['plain']}; need B5 = B2 = {TRAIN_MESH_STEPS} * "
                         f"(14 L + 1) = {want}, the rest 0, no plain version")
            res = ranks[0][dims]
            mesh_results[dims] = res
            print(f"phase 5r [{label}]: B5 words of each rank's rows equal one "
                  f"card's, alpha within 1e-5; losses "
                  + " ".join(f"{v:.5f}" for v in res["losses"])
                  + f" within rtol {TRAIN_MESH_RTOL} of one card's; clip norms "
                  + " ".join(f"{v:.6f}" for v in res["gnorms"])
                  + " (one card " + " ".join(f"{v:.6f}" for v in ref_gnorms)
                  + f", rtol {TRAIN_MESH_GNORM_RTOL}); attention and norm "
                  f"updates within {max(x[dims]['update_err'] for x in ranks):.3e} of "
                  f"one card's (relative, worst leaf and rank; need "
                  f"{TRAIN_MESH_UPDATE_TOL}); "
                  f"launches a rank "
                  f"B5 = B2 = {res['counts']['B5']} ({TRAIN_MESH_STEPS} x (14 L + 1)), "
                  f"B1 = B3 = B4 = B6 = 0, no plain version run; masters "
                  f"{res['held'] / 1e9:.3f} GB a rank; step {TRAIN_MESH_STEPS} "
                  f"{res['step_ms']:.1f} ms (one card {ref_ms:.1f}), "
                  f"{res['coll_n']} collectives {1e3 * res['coll_s']:.1f} ms = "
                  f"{res['coll_s'] * 1e3 / res['step_ms']:.3f} of it (each "
                  f"synchronized; ranks share one card over gloo: information, not "
                  f"a multi-card figure); peak {res['peak'] / 1e9:.2f} GB a rank",
                  flush=True)
        for dims in (d for d in MOE_TRAIN_MESHES if d[0] * d[1] == world):
            label = f"{MOE} mesh {dims} ({world} ranks sharing one card, {card})"
            want = TRAIN_MESH_STEPS * per_step
            for r, rank_res in enumerate(ranks):
                got = rank_res[("moe", dims)]
                if not all(math.isfinite(v) for v in got["losses"]) or any(
                        abs(a - b) > TRAIN_MESH_RTOL * abs(b)
                        for a, b in zip(got["losses"], moe_losses, strict=True)):
                    fail(f"{label} rank {r}: losses {got['losses']} vs one card's "
                         f"{moe_losses} (rtol {TRAIN_MESH_RTOL})")
                if any(abs(a - b) > TRAIN_MESH_GNORM_RTOL * abs(b)
                       for a, b in zip(got["gnorms"], moe_gnorms, strict=True)):
                    fail(f"{label} rank {r}: clip norms {got['gnorms']} vs one "
                         f"card's {moe_gnorms} (rtol {TRAIN_MESH_GNORM_RTOL})")
                c = got["counts"]
                if (c["B5"] != want or c["B2"] != want
                        or any(c[k] for k in ("B1", "B3", "B4", "B6")) or got["plain"]
                        or got["experts"] != moe.moe.n_experts // dims[1]):
                    fail(f"{label} rank {r}: launches {c}, plain versions "
                         f"{got['plain']}, {got['experts']} experts held; need B5 = "
                         f"B2 = {want}, the rest 0, E / TP = "
                         f"{moe.moe.n_experts // dims[1]}")
            got = ranks[0][("moe", dims)]
            mesh_results[("moe", dims)] = got
            print(f"phase 5r [{label}]: {got['experts']} of {moe.moe.n_experts} "
                  f"experts' masters a rank ({got['held'] / 1e9:.3f} GB of masters); "
                  f"losses " + " ".join(f"{v:.5f}" for v in got["losses"])
                  + f" within rtol {TRAIN_MESH_RTOL} and clip norms "
                  + " ".join(f"{v:.6f}" for v in got["gnorms"])
                  + f" within rtol {TRAIN_MESH_GNORM_RTOL} of one card's; launches a "
                  f"rank B5 = B2 = {got['counts']['B5']}, B1 = B3 = B4 = B6 = 0, no "
                  f"plain version run; step {TRAIN_MESH_STEPS} {got['step_ms']:.1f} ms "
                  f"(one card {moe_ms:.1f}), {got['coll_n']} collectives "
                  f"{1e3 * got['coll_s']:.1f} ms = "
                  f"{got['coll_s'] * 1e3 / got['step_ms']:.3f} of it; peak "
                  f"{got['peak'] / 1e9:.2f} GB a rank", flush=True)
        if "ef_sign" in parts:
            for r, res in enumerate(ranks):
                if not math.isfinite(res["ef_sign"]["loss"]):
                    fail(f"phase 5r EF-sign DP step (2, 1) rank {r}: loss "
                         f"{res['ef_sign']}")
            print(f"phase 5r EF-sign build_dp_train_step (2, 1), granite-8b full "
                  f"width L={L}: one step, loss {ranks[0]['ef_sign']['loss']:.5f} "
                  f"(finite), grad norm {ranks[0]['ef_sign']['grad_norm']:.3f}",
                  flush=True)
        if "gpipe" in parts:
            for r, res in enumerate(ranks):
                g = res["gpipe"]
                if (not g["finite"] or g["y_err"] > TRAIN_MESH_RTOL
                        or g["g_err"] > TRAIN_MESH_RTOL or g["counts"]["B5"] == 0
                        or g["counts"]["B2"] == 0):
                    fail(f"phase 5r GPipe stage {g['stage']}: outputs within "
                         f"{g['y_err']:.2e}, grads within {g['g_err']:.2e} of the "
                         f"stages in sequence (need {TRAIN_MESH_RTOL}), launches "
                         f"{g['counts']}")
            print(f"phase 5r GPipe, 2 stages x 1 full-width granite-8b block (fused), "
                  f"M={GPIPE_MICRO} microbatches of {GPIPE_MB}x{GPIPE_SEQ}: outputs "
                  f"within {max(r['gpipe']['y_err'] for r in ranks):.2e} and stage "
                  f"gradients within {max(r['gpipe']['g_err'] for r in ranks):.2e} "
                  f"x max of the stages run in sequence on one rank", flush=True)
        if "ckpt" in parts:
            small = get_config("granite-8b").reduced()
            model = train_mesh_model(small)
            template = init_state(model.init(0), adamw(1e-3))
            step, state = elastic_restore(TP_DIR / "train4" / "ckpt", template, None)
            digests = {}
            for name, tree in (("params", state.params), ("mu", state.opt_state.mu),
                               ("nu", state.opt_state.nu)):
                for path, v in mod.walk(tree):
                    digests[f"{name}/{'/'.join(path)}"] = hashlib.sha256(
                        v.detach().cpu().numpy().tobytes()).hexdigest()
            want = ranks[0]["ckpt"]
            if step != want["step"] or digests != want["digests"] or want["restarts"]:
                bad = [k for k in want["digests"] if digests.get(k) != want["digests"][k]]
                fail(f"phase 5r checkpoint (2, 2) -> one card: step {step} vs "
                     f"{want['step']}, {len(bad)} leaves differ: {bad[:3]}")
            print(f"phase 5r checkpoint written under (2, 2) (granite-8b reduced, "
                  f"fused on the card, 3 steps) and elastic_restore'd onto one card: "
                  f"step {step}, all {len(digests)} leaves (masters, both moments) "
                  f"equal to the state the ranks gathered (sha256)", flush=True)
            del model, template, state
        print(f"phase 5r job {list(dims_list)}: {dt:.1f}s from its go (rank 0: "
              + ", ".join(f"{k} {v:.1f}s" for k, v in ranks[0]["seconds"].items())
              + ")", flush=True)
    train_cli_mesh_finish(cli, card)
    release()
    print(f"phase 5r (training under a mesh, ranks sharing one card): "
          f"{time.perf_counter() - t_phase:.1f}s", flush=True)
    return mesh_results


def meta_grad_peak(cfg, batch: int, seq: int):
    """(peak bytes, {kernel id: calls}) of one forward + backward of
    ``cfg``'s fused train model on ``meta`` masters and a (batch, seq)
    token batch, counted by ``roofline.analysis.CostCounter``: the most
    bytes its ops hold alive at once (activations, saved products,
    recomputes, gradients), what phase 5d's forward + backward measures."""
    import torch

    from repro_torch.configs import build_model
    from repro_torch.nn import module as mod
    from repro_torch.nn.context import TRAIN, ModelContext
    from repro_torch.roofline.analysis import CostCounter

    model = build_model(cfg, ModelContext(policy=cfg.tbn, mode=TRAIN,
                                          compute_dtype=torch.bfloat16,
                                          device="meta", fused_train=True))
    params = mod.abstract_params(model.specs())
    leaves = [v.requires_grad_(True) for _, v in mod.walk(params)]
    tokens = torch.empty((batch, seq), dtype=torch.int64, device="meta")
    counter = CostCounter()
    with counter:
        loss, _ = model.train_forward(params, {"tokens": tokens})
        torch.autograd.grad(loss, leaves)
    return counter.peak_bytes, dict(counter.kernels)


def phase_dryrun(card: str, remat: dict, tile_rank: dict, mesh_results: dict) -> None:
    """Phase 11 (last): the dry run's counts (``launch.dryrun.count_cell``:
    the cell built for one rank on ``meta`` tensors under a fake process
    group of the mesh's size, its step run once under
    ``roofline.analysis.CostCounter``; nothing runs on the card) against
    what this run measured on the card: the tile bytes a rank of
    granite-8b serving at (1, 2) (phase 4r), the collectives a train step
    and their kinds of granite-8b at (1, 2), (2, 1), (2, 2) and of
    qwen2-moe at (1, 2), (2, 2) (phase 5r's step 2), each exactly; phase
    5d's state bytes exactly and its B5 / B2 launches, and each remat
    policy's predicted step peak (state and batch plus the most bytes the
    step's ops hold alive) and forward + backward peak
    (``meta_grad_peak``) against phase 5d's ``max_memory_allocated``
    within DRYRUN_PEAK_TOL."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.dryrun import count_cell

    t0 = time.perf_counter()
    granite = get_config("granite-8b")
    served = count_cell(granite, ShapeCell("4r", 64, N_SLOTS, "decode"), (1, 2))
    if set(tile_rank.values()) != {served["tile_bytes"]}:
        fail(f"phase 11: the dry run's tile bytes a rank at (1, 2) "
             f"{served['tile_bytes']} vs phase 4r's {tile_rank}")
    print(f"phase 11 [dry run vs phase 4r, {card}]: granite-8b serving at (1, 2), "
          f"tile bytes a rank {served['tile_bytes']} (counted on meta) = "
          f"{sorted(set(tile_rank.values()))} (held on the card's ranks)",
          flush=True)
    step_cell = ShapeCell("step", TRAIN_SEQ, TRAIN_BATCH, "train")
    for arch, layers, key in (("granite-8b", TRAIN_MESH_LAYERS, lambda d: d),
                              (MOE, TP_MOE_LAYERS, lambda d: ("moe", d))):
        cut = dataclasses.replace(get_config(arch), n_layers=layers)
        for dims in ((1, 2), (2, 1), (2, 2)):
            if key(dims) not in mesh_results:
                continue
            counted = count_cell(cut, step_cell, dims)["coll_calls"]
            seen = mesh_results[key(dims)]["kinds"]
            if counted != seen:
                fail(f"phase 11: {arch} L={layers} at {dims}: the dry run counts "
                     f"{counted} collectives a step, phase 5r's step 2 ran {seen}")
            print(f"phase 11 [dry run vs phase 5r, {card}]: {arch} L={layers} at "
                  f"{dims}: {sum(counted.values())} collectives a step "
                  + " ".join(f"{k} {v}" for k, v in sorted(counted.items()))
                  + " (meta) = phase 5r's step 2 on the card's ranks", flush=True)
    for mode in REMAT_MODES:
        cut = dataclasses.replace(granite, n_layers=TRAIN_LAYERS, remat=mode)
        got = count_cell(cut, step_cell, (1, 1))
        card_run = remat[mode]
        want_k = {k: v for k, v in card_run["counts"].items() if v}
        if got["state_bytes"] != card_run["state_bytes"] or got["kernels"] != want_k:
            fail(f"phase 11 remat={mode}: the dry run's state {got['state_bytes']} B "
                 f"and kernels {got['kernels']} vs phase 5d's "
                 f"{card_run['state_bytes']} B and {want_k}")
        predicted = got["argument_bytes"] + got["peak_bytes"]
        ratio = predicted / card_run["peak"]
        if abs(ratio - 1) > DRYRUN_PEAK_TOL:
            fail(f"phase 11 remat={mode}: predicted step peak {predicted / 1e9:.3f} "
                 f"GB vs max_memory_allocated {card_run['peak'] / 1e9:.3f} GB "
                 f"(ratio {ratio:.3f}, need within {DRYRUN_PEAK_TOL})")
        fb_peak, fb_kernels = meta_grad_peak(cut, REMAT_BATCH, TRAIN_SEQ)
        want_fb = {k: v for k, v in card_run["fb_counts"].items() if v}
        fb_ratio = fb_peak / card_run["fb_peak"]
        if fb_kernels != want_fb or abs(fb_ratio - 1) > DRYRUN_PEAK_TOL:
            fail(f"phase 11 remat={mode}: forward + backward at {REMAT_BATCH}x"
                 f"{TRAIN_SEQ} predicted peak {fb_peak / 1e9:.3f} GB and kernels "
                 f"{fb_kernels} vs phase 5d's {card_run['fb_peak'] / 1e9:.3f} GB "
                 f"and {want_fb} (ratio {fb_ratio:.3f}, need within "
                 f"{DRYRUN_PEAK_TOL})")
        print(f"phase 11 [dry run vs phase 5d, {card}]: granite-8b L={TRAIN_LAYERS} "
              f"remat={mode}: state {got['state_bytes']} B = the card's; launches "
              f"{got['kernels']} = the card's; step peak predicted "
              f"{predicted / 1e9:.3f} GB (state and batch "
              f"{got['argument_bytes'] / 1e9:.3f} + the ops' "
              f"{got['peak_bytes'] / 1e9:.3f}) against max_memory_allocated "
              f"{card_run['peak'] / 1e9:.3f} GB: ratio {ratio:.4f}; forward + "
              f"backward at {REMAT_BATCH}x{TRAIN_SEQ}: launches {fb_kernels} = the "
              f"card's, peak predicted {fb_peak / 1e9:.3f} GB against "
              f"{card_run['fb_peak'] / 1e9:.3f} GB: ratio {fb_ratio:.4f} (bound "
              f"1 +- {DRYRUN_PEAK_TOL} each)", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    print(f"phase 11 (the dry run against the card): "
          f"{time.perf_counter() - t0:.1f}s", flush=True)


def main() -> None:
    global TP_DIR
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

    t_run = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)
    # phase 4r's saved exports; removed however the run ends
    TP_DIR = Path(tempfile.mkdtemp(prefix="chip_smoke_tp_"))
    atexit.register(shutil.rmtree, TP_DIR, ignore_errors=True)
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
    phase_features_granite(cfg, sp)
    phase_http_granite(cfg, sp)
    tp_save("granite", sp)
    del sp
    qwen = get_config(QWEN)
    sp, counts = phase_serve_paths(
        dataclasses.replace(qwen, n_layers=QWEN_SERVE_LAYERS), "4b")
    phase_qwen_card_vs_cpu(qwen, sp)
    del sp
    for arch in ("minitron-8b", "starcoder2-7b"):
        counts = {k: counts[k] + v for k, v in phase_serve_family(
            arch, n_layers=FAMILY_SERVE_LAYERS)[1].items() if k in counts}
    moe = get_config(MOE)
    sp, moe_counts = phase_serve_paths(
        dataclasses.replace(moe, n_layers=MOE_SERVE_LAYERS), "4e")
    phase_moe_card_vs_cpu(moe, sp)
    tp_save("moe", sp, TP_MOE_LAYERS)
    del sp
    release()
    moe_counts = {k: moe_counts[k] + v for k, v in phase_serve_family(
        MOONSHOT, "4f", profile_ticks=1,
        n_layers=MOONSHOT_SERVE_LAYERS)[1].items() if k in moe_counts}
    rec_counts = dict.fromkeys(moe_counts, 0)
    for arch, phase, lens in ((MAMBA, "4h", (600, 200)),
                              (RECGEMMA, "4i", (WRAP_PROMPT, 300))):
        sp, part = phase_serve_recurrent(arch, phase)
        rec_counts = {k: rec_counts[k] + part[k] for k in rec_counts}
        phase_recurrent_card_vs_cpu(get_config(arch), sp, lens)
        if arch == MAMBA:
            phase_features_mamba(dataclasses.replace(
                get_config(arch), n_layers=MAMBA_SERVE_LAYERS), sp)
        del sp
        release()
    seamless = get_config(SEAMLESS)
    sp, enc_counts = phase_serve_paths(seamless, "4k", requests=SEAMLESS_REQUESTS)
    phase_encdec_card_vs_cpu(seamless, sp)
    phase_features_seamless(seamless, sp)
    del sp
    release()
    sp, part = phase_serve_family(CHAMELEON, "4l", profile_ticks=1,
                                  n_layers=CHAMELEON_SERVE_LAYERS)
    enc_counts = {k: enc_counts[k] + part.get(k, 0) for k in enc_counts}
    phase_card_vs_cpu(get_config(CHAMELEON), sp, paths=("float",))
    del sp
    release()
    for part in (counts, moe_counts, rec_counts, enc_counts):
        for k, v in part.items():
            launches[k] += v
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_train_fused(cfg)
    remat = phase_train_remat(cfg, card)
    for arch in ("granite-8b", MOE, SEAMLESS):
        phase_train_cli(arch)
    phase_train_card_vs_cpu(cfg)
    conv = phase_conv(card)
    sp34, r34 = phase_resnet34()
    phase_resnet34_card_vs_cpu(sp34)
    tile_rank = phase_tp(card, sp34)
    del sp34
    mesh_results = phase_train_mesh(card)
    phase_dryrun(card, remat, tile_rank, mesh_results)

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
    print(f"chip_smoke: {time.perf_counter() - t_run:.1f}s, the build and every "
          f"phase", flush=True)
    print(f"card: {card_line()}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp-rank"]:
        tp_rank_main(sys.argv[2])
    elif sys.argv[1:2] == ["--train-rank"]:
        train_mesh_rank_main(sys.argv[2])
    else:
        main()
