"""Batched serving engine: slot-based continuous batching with chunked
prefill fused into the decode tick (port of the core tick of
``repro/serve/engine.py``).

* ``n_slots`` sequences share a paged K/V pool when the model has full
  attention: in the compute dtype, or int8 codes with per-token, per-head
  f32 scales where the config's ``kv_dtype`` is "int8" (the model's
  ``init_caches`` decides; the engine only carries the pools). The other
  cache families are per slot (SSM and RG-LRU carries, sliding-window
  rings): a model with no full attention (mamba2-370m, recurrentgemma-2b)
  gets no pool and no pages at all, and admission zeroes the slot's
  per-slot rows (``reset_slot``). A request moves from
  PREFILL (its prompt streamed into the caches ``chunk_tokens`` columns at
  a time by one fixed-shape ``(n_slots, chunk_tokens)`` ``model.extend``)
  to DECODE (one token per tick through the ``(n_slots, 1)`` decode step).
* Each tick: FIFO admissions into free slots, a token-budget pass
  (decode-priority: every decoding slot is charged one token, the rest of
  ``chunk_tokens`` goes to prefilling slots in admission order, the head
  always getting at least one), then one extend call (m = n_slots *
  chunk_tokens rows -> kernel B2) and one decode call (m = n_slots rows ->
  kernel B1, or B3 / B4 under ``compute_path`` "xnor" / "int8").
* The page table is host state. Before each call it is copied into a
  static device buffer, as are the tick's other inputs (the token block,
  the per-slot new-token counts, the active mask). Logits stay on the
  device; only the sampled token ids come back.
* Each tick is a function over static tensors (``_decode_tick``,
  ``_extend_tick``, and ``_reset_slot`` for a model with per-slot caches)
  that writes the caches and ``lengths`` in place; the host side (pages,
  the schedule, sampling, emitting and retiring) stays eager. A decode
  tick leaves every inactive slot's per-slot rows bit-identical.
  ``warmup()`` captures each as a CUDA graph (``serve/graphs.py``), the
  counterpart of the reference's AOT-compiled tick executables; every
  later tick replays its graph. Sampling runs eagerly on the replayed
  logits: it seeds a ``torch.Generator`` per stochastic row from host
  seeds, which a replay cannot do.

Waiting for later slices: the prefix trie, priorities and preemption, the
ENCODE phase, telemetry and mesh placement.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels.ops import check_compute_path
from repro_torch.nn import module as mod
from repro_torch.serve.graphs import TickGraph
from repro_torch.serve.kvpool import KVPool
from repro_torch.serve.sampling import SamplingParams, row_seed, sample_logits_batch

PREFILL = "prefill"
DECODE = "decode"
# Bumped in the Python body of each tick function. A replayed graph runs
# none of it, so a warm engine that serves without moving these counters
# started no new capture and no eager tick (the reference's trace probe).
TRACE_COUNTS: "collections.Counter[str]" = collections.Counter()


def _check_in_place(caches: list, returned: list, what: str) -> None:
    """Every cache is written in place (the pools by nn/attention.
    scatter_pages, the per-slot leaves by the model's layer walk): a model
    must hand back the very tensors the engine holds, which its captured
    graphs read and write. Walks nested (pattern) caches."""
    for held, got in zip(caches, returned, strict=True):
        got_leaves = dict(mod.walk(got))
        for path, v in mod.walk(held):
            if got_leaves.get(path) is not v:
                raise RuntimeError(f"{what}: the model returned a new "
                                   f"{'/'.join(path)} cache tensor; the "
                                   f"engine's caches must be written in "
                                   f"place")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (len,) int32
    params: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    finish_reason: Optional[str] = None  # "eos" | "length"
    token_steps: List[int] = dataclasses.field(default_factory=list)
    # engine tick at which each output token was emitted


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    n_slots: int = 4
    max_len: int = 256                  # cache capacity per slot
    chunk_tokens: int = 32              # extend width == per-tick token budget
    temperature: float = 0.0
    top_k: Optional[int] = None
    seed: int = 0
    page_tokens: int = 16               # KV pool: n_slots * max_len / page_tokens pages
    compute_path: str = "float"         # dense serve compute: "float" |
    # "int8" | "xnor" (kernels/tiled_xnor.py); the model must be built with
    # the same ModelContext.compute_path (the engine checks)

    def __post_init__(self):
        if self.n_slots < 1:
            raise ValueError(f"n_slots must be >= 1: {self.n_slots}")
        if self.max_len < 1:
            raise ValueError(f"max_len must be >= 1: {self.max_len}")
        if not 0 < self.chunk_tokens <= self.max_len:
            raise ValueError(f"chunk_tokens must be in (0, max_len="
                             f"{self.max_len}]: {self.chunk_tokens}")
        if self.page_tokens <= 0 or self.max_len % self.page_tokens:
            raise ValueError(f"page_tokens {self.page_tokens} must be positive "
                             f"and divide max_len {self.max_len}")
        check_compute_path(self.compute_path)


class BatchedEngine:
    """Serves ``model`` (a SERVE-mode ``DecoderLM``) from ``params`` on the
    model's device; the params must already live there."""

    def __init__(self, model, params, cfg: ServeConfig):
        self.model = model
        self.device = model.device
        for path, leaf in mod.walk(params):
            if leaf.device.type != self.device.type:
                raise ValueError(f"param {'/'.join(path)} is on {leaf.device}, "
                                 f"the model runs on {self.device}")
        if model.ctx.compute_path != cfg.compute_path:
            raise ValueError(f"ServeConfig.compute_path {cfg.compute_path!r} "
                             f"but the model was built with "
                             f"{model.ctx.compute_path!r}")
        self.params = params
        self.cfg = cfg
        self._queue: collections.deque = collections.deque()
        self._live: Dict[int, Request] = {}
        self._free = list(range(cfg.n_slots))
        self._rid = itertools.count()
        self._phase: List[Optional[str]] = [None] * cfg.n_slots
        self._offsets = np.zeros((cfg.n_slots,), np.int64)
        self._admit_order: List[int] = []

        self.pt = cfg.page_tokens
        self.npp = cfg.max_len // self.pt
        n_pages = cfg.n_slots * self.npp
        # a page pool only for full attention (reference engine)
        self.pool = KVPool(n_pages, self.pt) if model.has_full_attn else None
        self._ptab = np.zeros((cfg.n_slots, self.npp), np.int32)
        self._n_mapped = np.zeros((cfg.n_slots,), np.int64)
        # float pools and rings take the model's compute dtype (reference
        # engine); an int8 KV config allocates int8 codes and f32 scales
        # whatever it is, and recurrent carries are f32
        self.caches = model.init_caches(cfg.n_slots, cfg.max_len,
                                        model.ctx.compute_dtype,
                                        page_tokens=self.pt, n_pages=n_pages)
        self._stateful = model.has_recurrent_state
        self.lengths = torch.zeros((cfg.n_slots,), dtype=torch.int32,
                                   device=self.device)
        self.tokens = torch.zeros((cfg.n_slots, 1), dtype=torch.int64,
                                  device=self.device)
        # the ticks' per-call inputs, filled in place before each call
        self._ptab_t = torch.zeros((cfg.n_slots, self.npp), dtype=torch.int32,
                                   device=self.device)
        self._active_t = torch.zeros((cfg.n_slots,), dtype=torch.bool,
                                     device=self.device)
        self._block_t = torch.zeros((cfg.n_slots, cfg.chunk_tokens),
                                    dtype=torch.int64, device=self.device)
        self._n_new_t = torch.zeros((cfg.n_slots,), dtype=torch.int32,
                                    device=self.device)
        # the slot that reset_slot zeroes; n_slots (no slot) outside a reset
        self._slot_t = torch.full((), cfg.n_slots, dtype=torch.int64,
                                  device=self.device)
        self._graphs: Dict[str, TickGraph] = {}
        self._warm_s: Dict[str, float] = {}
        # per-slot sampling state, host side
        self._temps = np.zeros((cfg.n_slots,), np.float64)
        self._topks = np.zeros((cfg.n_slots,), np.int64)
        self._eos_ids = np.full((cfg.n_slots,), -1, np.int64)
        self._streams: List[tuple] = [()] * cfg.n_slots
        self._counts = np.zeros((cfg.n_slots,), np.int64)
        self._stats = {"admitted": 0, "prompt_tokens": 0, "tokens_out": 0,
                       "extend_ticks": 0, "decode_ticks": 0}
        self._phase_s = {"extend": 0.0, "decode": 0.0}
        self.steps = 0

    # ------------------------------------------------------------------
    def submit(self, prompt, params: Optional[SamplingParams] = None) -> Request:
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or len(prompt) == 0:
            raise ValueError("prompt must be a non-empty 1-D token sequence")
        if len(prompt) > self.cfg.max_len:
            raise ValueError(
                f"prompt len {len(prompt)} exceeds max_len {self.cfg.max_len}")
        req = Request(rid=next(self._rid), prompt=prompt,
                      params=params or SamplingParams())
        self._queue.append(req)
        return req

    @property
    def has_work(self) -> bool:
        return bool(self._live) or bool(self._queue)

    def _admit(self, slot: int, req: Request):
        """O(1) admission: claim the slot and pin the request's sampling
        state to it; prefill starts at position 0 on the next schedule."""
        self._live[slot] = req
        self._phase[slot] = PREFILL
        self._admit_order.append(slot)
        self._stats["admitted"] += 1
        self._stats["prompt_tokens"] += len(req.prompt)
        self._offsets[slot] = 0
        self.lengths[slot] = 0
        if self._stateful:
            # the paged pools need no device work at admission
            self._slot_t.fill_(slot)
            self._tick("reset_slot")
        res = req.params.resolve(self.cfg.temperature, self.cfg.top_k)
        self._temps[slot] = res.temperature
        self._topks[slot] = res.top_k
        self._eos_ids[slot] = res.eos_id
        self._streams[slot] = ((res.seed,) if res.seed is not None
                               else (self.cfg.seed, req.rid))
        self._counts[slot] = 0

    def _admissions(self):
        while self._free and self._queue:
            self._admit(self._free.pop(0), self._queue.popleft())

    def _maybe_retire(self, slot: int, req: Request, tok: int) -> bool:
        """EOS before the length cap; the cache-capacity cap retires a
        sequence whose next decode step would write past max_len."""
        if tok == int(self._eos_ids[slot]):
            req.finish_reason = "eos"
        elif len(req.output) >= req.params.max_tokens:
            req.finish_reason = "length"
        elif len(req.prompt) + len(req.output) > self.cfg.max_len:
            req.finish_reason = "length"
        else:
            return False
        req.done = True
        self._release_slot(slot)
        return True

    def _release_slot(self, slot: int):
        if self.pool is not None:
            for i in range(int(self._n_mapped[slot])):
                self.pool.release(int(self._ptab[slot, i]))
        self._n_mapped[slot] = 0
        self._live.pop(slot, None)
        self._free.append(slot)
        self._phase[slot] = None
        if slot in self._admit_order:
            self._admit_order.remove(slot)
        self._temps[slot] = 0.0
        self._topks[slot] = 0
        self._eos_ids[slot] = -1
        self._counts[slot] = 0

    def _alloc_page(self) -> int:
        pid = self.pool.alloc()
        if pid is None:
            # every slot maps at most max_len / page_tokens pages
            raise RuntimeError(f"KV page pool exhausted ({self.pool.n_pages} "
                               f"pages for {self.cfg.n_slots} slots): a slot "
                               f"leaked its pages")
        return pid

    def _ensure_pages(self, slot: int, last_pos: int):
        """Grow the slot's page table to cover ``last_pos``; positions past
        the table's reach are dropped by the scatter. A model without a
        pool maps no pages."""
        if self.pool is None:
            return
        need = min(last_pos // self.pt, self.npp - 1)
        while self._n_mapped[slot] <= need:
            self._ptab[slot, self._n_mapped[slot]] = self._alloc_page()
            self._n_mapped[slot] += 1

    def _schedule_prefill(self, n_decoding: int) -> Dict[int, int]:
        """Token-budget pass: chunk_tokens per tick, decode-priority; the
        head of the prefill queue always gets at least one token."""
        c = self.cfg.chunk_tokens
        budget = c - n_decoding
        takes: Dict[int, int] = {}
        first = True
        for slot in self._admit_order:
            if self._phase[slot] != PREFILL:
                continue
            rem = len(self._live[slot].prompt) - int(self._offsets[slot])
            take = min(c, rem, max(budget, 1 if first else 0))
            first = False
            if take <= 0:
                continue
            takes[slot] = take
            budget -= take
        return takes

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        seeds = [row_seed(self._streams[s], int(self._counts[s]))
                 if self._temps[s] > 0 else None
                 for s in range(self.cfg.n_slots)]
        return sample_logits_batch(logits, self._temps, self._topks, seeds)

    def _emit(self, slot: int, req: Request, tok: int):
        req.output.append(tok)
        req.token_steps.append(self.steps)
        self._counts[slot] += 1
        self._stats["tokens_out"] += 1

    # ------------------------------------------------------------------
    # tick functions: static tensors in, logits out, state written in place
    # ------------------------------------------------------------------
    def _decode_tick(self) -> torch.Tensor:
        """The (n_slots, 1) decode step for the ``active`` slots: pool writes
        confined to them, then lengths = where(active, new, old). Returns
        the (n_slots, vocab) logits."""
        TRACE_COUNTS["decode_tick"] += 1
        active = self._active_t
        logits, new_caches, new_lengths = self.model.decode_step(
            self.params, self.tokens, self.caches, self.lengths, self._ptab_t,
            active=active)
        _check_in_place(self.caches, self.model.merge_caches(
            self.caches, new_caches, active, paged=True), "decode_tick")
        self.lengths.copy_(torch.where(active, new_lengths, self.lengths))
        return logits

    def _extend_tick(self) -> torch.Tensor:
        """One (n_slots, chunk_tokens) chunked-prefill step: each slot
        advances by its ``n_new`` tokens of the block (0: untouched).
        Returns each slot's last-column logits (n_slots, vocab)."""
        TRACE_COUNTS["extend_tick"] += 1
        logits, caches, lengths = self.model.extend(
            self.params, self._block_t, self.caches, self.lengths,
            self._n_new_t, self._ptab_t)
        _check_in_place(self.caches, caches, "extend_tick")
        self.lengths.copy_(lengths)
        return logits

    def _reset_slot(self) -> None:
        """Zero the per-slot cache rows of slot ``_slot_t`` (recurrent
        carries must restart from zeros; rings are cleared too); the paged
        pools are left alone. A slot index of n_slots zeroes nothing."""
        TRACE_COUNTS["reset_slot"] += 1
        _check_in_place(self.caches, self.model.reset_slot_caches(
            self.caches, self._slot_t, paged=True), "reset_slot")

    def _entry_points(self):
        """name -> (tick function, the static tensors it reads or writes
        besides the params). ``reset_slot`` only for a model with per-slot
        caches."""
        caches = {f"caches[{i}].{'.'.join(p)}": v
                  for i, c in enumerate(self.caches) for p, v in mod.walk(c)}
        points = {
            "decode_tick": (self._decode_tick, {
                "tokens": self.tokens, "lengths": self.lengths,
                "ptab": self._ptab_t, "active": self._active_t, **caches}),
            "extend_tick": (self._extend_tick, {
                "block": self._block_t, "lengths": self.lengths,
                "n_new": self._n_new_t, "ptab": self._ptab_t, **caches}),
        }
        if self._stateful:
            points["reset_slot"] = (self._reset_slot,
                                    {"slot": self._slot_t, **caches})
        return points

    def _tick(self, name: str) -> torch.Tensor:
        graph = self._graphs.get(name)
        if graph is not None:
            return graph.run()
        return getattr(self, f"_{name}")()

    def warmup(self) -> Dict[str, float]:
        """Capture the decode tick, the extend tick and, for a model with
        per-slot caches, the slot reset, for this engine's shapes (a CUDA
        graph each, sharing one memory pool; on the CPU one eager run each,
        no graph), so that serving replays them. Returns the seconds per
        entry point, warm-up runs included.

        The warm-up runs and the capture see every per-tick input zeroed:
        no slot active, no new tokens, no slot to reset. Every pool write
        then lands on the scratch page, every per-slot row keeps its value,
        and ``lengths`` and ``tokens`` stay as they were, so a mid-flight
        warmup changes no request. A second call is a no-op that
        returns the first call's seconds. Raises ``RuntimeError`` naming
        the entry point and its buffers' shapes if a run or a capture
        fails; the engine then stays cold (no quiet half warmup)."""
        if self._graphs:
            return dict(self._warm_s)
        self._ptab_t.copy_(torch.from_numpy(self._ptab))
        self._active_t.zero_()
        self._block_t.zero_()
        self._n_new_t.zero_()
        self._slot_t.fill_(self.cfg.n_slots)
        pool = (torch.cuda.graph_pool_handle() if self.device.type == "cuda"
                else None)
        graphs, timings = {}, {}
        with torch.no_grad():
            for name, (fn, buffers) in self._entry_points().items():
                graphs[name] = TickGraph(name, fn, buffers, self.device)
                timings[name] = graphs[name].capture(pool)
        self._graphs, self._warm_s = graphs, timings
        return dict(timings)

    @property
    def aot_warm(self) -> bool:
        return bool(self._graphs)

    # ------------------------------------------------------------------
    # host side of the ticks
    # ------------------------------------------------------------------
    def _run_extend(self, takes: Dict[int, int]):
        cfg = self.cfg
        t0 = time.perf_counter()
        block = np.zeros((cfg.n_slots, cfg.chunk_tokens), np.int64)
        n_new = np.zeros((cfg.n_slots,), np.int32)
        for slot, take in takes.items():
            off = int(self._offsets[slot])
            block[slot, :take] = self._live[slot].prompt[off:off + take]
            n_new[slot] = take
            self._ensure_pages(slot, off + take - 1)
        self._block_t.copy_(torch.from_numpy(block))
        self._n_new_t.copy_(torch.from_numpy(n_new))
        self._ptab_t.copy_(torch.from_numpy(self._ptab))
        toks = self._sample(self._tick("extend_tick"))
        toks_host = toks.tolist()
        for slot, take in takes.items():
            req = self._live[slot]
            self._offsets[slot] += take
            if self._offsets[slot] == len(req.prompt):
                # prompt complete: the chunk's last-column logits give the
                # request's first token
                self._phase[slot] = DECODE
                self._admit_order.remove(slot)
                tok = toks_host[slot]
                self._emit(slot, req, tok)
                self.tokens[slot, 0] = tok
                self._maybe_retire(slot, req, tok)
        self._stats["extend_ticks"] += 1
        self._phase_s["extend"] += time.perf_counter() - t0

    def _run_decode(self, decoding: List[int]):
        t0 = time.perf_counter()
        active = np.zeros((self.cfg.n_slots,), bool)
        active[decoding] = True
        for slot in decoding:
            req = self._live[slot]
            pos = len(req.prompt) + len(req.output) - 1  # row this step writes
            if pos < self.cfg.max_len:
                self._ensure_pages(slot, pos)
        self._active_t.copy_(torch.from_numpy(active))
        self._ptab_t.copy_(torch.from_numpy(self._ptab))
        logits = self._tick("decode_tick")
        nxt = torch.where(self._active_t, self._sample(logits), self.tokens[:, 0])
        self.tokens.copy_(nxt[:, None])
        nxt_host = nxt.tolist()
        for slot in decoding:
            req = self._live[slot]
            tok = nxt_host[slot]
            self._emit(slot, req, tok)
            self._maybe_retire(slot, req, tok)
        self._stats["decode_ticks"] += 1
        self._phase_s["decode"] += time.perf_counter() - t0

    def step(self):
        """One engine tick: admissions, scheduled prefill chunks, then one
        batched decode step. Every slot decoding at the start of the tick
        emits exactly one token; a prefilling slot emits its first token on
        the tick its last chunk lands."""
        with torch.no_grad():
            self._admissions()
            if not self._live:
                return
            decoding = [s for s in range(self.cfg.n_slots)
                        if self._phase[s] == DECODE]
            takes = self._schedule_prefill(len(decoding))
            if takes:
                self._run_extend(takes)
            if decoding:
                self._run_decode(decoding)
        self.steps += 1

    def stats(self) -> Dict[str, object]:
        """Ticks, tokens, admissions, pool pages, the compute path, whether
        the ticks replay captured graphs (``aot_warm``), and the mean wall
        time of the extend and decode phases (host clock; each phase ends by
        copying its sampled tokens to the host, so it includes the device
        work)."""
        s = dict(self._stats)
        s["ticks"] = self.steps
        s["pool_pages"] = self.pool.n_pages if self.pool is not None else 0
        s["pages_in_use"] = self.pool.used_pages if self.pool is not None else 0
        s["compute_path"] = self.cfg.compute_path
        s["aot_warm"] = self.aot_warm
        for phase in ("extend", "decode"):
            n = s[f"{phase}_ticks"]
            s[f"{phase}_ms_mean"] = 1e3 * self._phase_s[phase] / n if n else 0.0
        return s

    def run_until_drained(self, max_steps: int = 10_000, on_tick=None) -> int:
        """Step until every submitted request completes; returns the tick
        count. ``on_tick(engine)`` runs after each tick."""
        for i in range(max_steps):
            if not self.has_work:
                return i
            self.step()
            if on_tick is not None:
                on_tick(self)
        raise RuntimeError(
            f"engine did not drain after {max_steps} steps: "
            f"{len(self._queue)} queued, {len(self._live)} live")
