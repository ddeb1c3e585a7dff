"""Batched serving engine: slot-based continuous batching with chunked
prefill fused into the decode tick, shared-prefix reuse, priorities with
preempt-and-resume, and telemetry (port of ``repro/serve/engine.py``).

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
* An encoder-decoder model (``has_cross_attn``: seamless-m4t) gets a
  second, read-only pool for its cross-attention K/V, with its own page
  table ``(n_slots, ceil(enc_tokens / page_tokens))`` and per-slot encoder
  lengths. Its requests carry source frames and start in ENCODE: one
  fixed-shape encoder pass over ``(1, enc_tokens, d)`` padded frames
  (``encode_tick``), which writes the request's cross rows once; the
  decode and extend ticks only read them.
* Each tick: the preempt pass (``preempt``), admissions and resumes into
  free slots, at most one ENCODE (in admission order; a source the
  EncoderCache holds maps in without one; its charge, min(frames,
  chunk_tokens), comes off the prefill budget), a token-budget pass
  (decode-priority: every decoding slot is charged one token, the rest of
  ``chunk_tokens`` goes to prefilling slots in admission order, the head
  always getting at least one), then one extend call (m = n_slots *
  chunk_tokens rows -> kernel B2) and one decode call (m = n_slots rows ->
  kernel B1, or B3 / B4 under ``compute_path`` "xnor" / "int8").
* With ``prefix_cache`` a radix trie over prompt token ids
  (``serve/prefix.py``) pins completed page runs and, for a model with
  per-slot state, snapshots of that state at page boundaries. Admission
  maps the longest cached prefix into the slot's page table (refcounted,
  no K/V copy), restores the deepest snapshot, and prefill starts at the
  first uncached token; retirement publishes the prompt's pages; LRU leaf
  eviction reclaims pages when the pool runs dry. On a stateful model a
  chunk never crosses a boundary that still needs a snapshot, so each
  snapshot is taken exactly at its boundary. A cross model keeps the trie
  off (its self-attention K/V depends on the source) and reuses encoder
  outputs instead: the EncoderCache maps a repeated source's cross pages.
* Scheduling under pressure: requests carry a class (``interactive`` >
  ``batch``). With ``priorities`` admission orders candidates by (class,
  uncached prefill tokens, submission), with an aging floor
  (``starvation_limit``). With ``preempt`` a waiting request of a strictly
  higher class parks a lower-class slot: its pages stay retained, its
  per-slot rows are snapshotted at the current position, and its host
  registers (offset, length, last token, emitted count = the sampler's
  token index) ride in a :class:`PreemptedState` until it resumes into any
  free slot, byte-exactly. ``max_preempts`` makes a request immune.
* The page table is host state. Before each call it is copied into a
  static device buffer, as are the tick's other inputs (the token block,
  the per-slot new-token counts, the active mask, the slot to reset,
  snapshot or restore, and the snapshot to restore). Logits stay on the
  device; only the sampled token ids come back.
* Each tick is a function over static tensors (``_decode_tick``,
  ``_extend_tick``, ``_reset_slot`` / ``_snapshot_slot`` /
  ``_restore_slot`` for a model with per-slot caches and ``_encode_tick``
  for one with cross attention) that writes the caches and ``lengths`` in
  place; the host side (pages, the schedule, sampling, emitting and
  retiring) stays eager. A decode tick leaves every inactive slot's
  per-slot rows bit-identical. ``warmup()`` captures each as a CUDA graph
  (``serve/graphs.py``), the counterpart of the reference's AOT-compiled
  tick executables; every later tick replays its graph. A captured
  snapshot writes into its graph's static output, so the engine clones it
  into tensors the trie node or the parked request owns. Sampling runs
  eagerly on the replayed logits: it seeds a ``torch.Generator`` per
  stochastic row from host seeds, which a replay cannot do.
* Telemetry (``telemetry``, on by default, ``serve/telemetry.py``) is
  observation only: request spans, tick phase histograms, an optional
  trace-event ring, and a detector of tick bodies that run eagerly after
  ``warmup()`` (read from ``TRACE_COUNTS``).
* ``mesh=`` (a ("data", "model") ``DeviceMesh``, ``launch/mesh.py``) serves
  tensor- and expert-parallel: the engine keeps this rank's block of the
  params (``distributed.sharding.place_params``) and runs every tick under
  ``axis_rules``, so each tiled layer runs on its r/TP rows and gathers
  the rest; an architecture whose ``attn_act`` is "heads" attends on the
  rank's block of the heads where the model axis divides them, its pools
  (built under the rules too) holding that block of the K/V heads; one
  whose ``attn_act`` is "seq" holds the rank's rows of each page (the
  positions = its index mod TP) and of each window ring, and merges the
  ranks' partial softmaxes. Where the data axes divide ``n_slots``
  (``distributed.sharding.slot_sharding``, the reference's "act_batch"),
  data rank d runs slots [d n / DP, (d + 1) n / DP): the model's entry
  points take its rows, its per-slot caches hold its slots, it samples its
  rows and the tick's ids are gathered over the data axes; the pools stay
  whole on every rank (a trie hit or a resume may cross data blocks), each
  layer's new K/V rows gathered before they are written, and a slot's
  snapshot is gathered so that any data rank can restore it. Page ids and
  page tables are global and equal on every rank; only what each page
  holds differs. Every rank runs the same tick bodies. The mesh's first rank
  alone takes ``submit`` / ``abort`` / ``abort_all`` and mirrors them to
  the other ranks at the start of each ``step()``; those ranks run
  ``follow()`` until ``stop_followers()`` (the tick control,
  ``serve/control.py``), so their schedules stay the first rank's. Each
  tick's sampled ids are broadcast from the first rank too.
  ``warmup()`` under a mesh is collective (every rank calls it at the
  same point of its schedule): a tick is captured as graphs split at
  each of its collectives, which run between the replays
  (``serve/graphs.py``); sampling and the ids' broadcast stay eager.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import itertools
import threading
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.distributed.sharding import (
    axis_rules,
    broadcast_from_first,
    place_params,
    slot_sharding,
)
from repro_torch.kernels.ops import check_compute_path
from repro_torch.nn import module as mod
from repro_torch.serve.control import TickControl
from repro_torch.serve.graphs import TickGraph
from repro_torch.serve.kvpool import KVPool
from repro_torch.serve.prefix import EncoderCache, PrefixTrie
from repro_torch.serve.sampling import SamplingParams, row_seed, sample_logits_batch
from repro_torch.serve.servable import ensure_servable
from repro_torch.serve.telemetry import PARKED, EngineTelemetry, RequestSpan

ENCODE = "encode"
PREFILL = "prefill"
DECODE = "decode"
# Priority classes, best first: rank 0 outranks rank 1. submit() rejects any
# other name, so a typo fails instead of scheduling at an unintended class.
PRIORITY_RANKS: Dict[str, int] = {"interactive": 0, "batch": 1}
# Bumped in the Python body of each tick function. A replayed graph runs
# none of it, so a warm engine that serves without moving these counters
# started no new capture and no eager tick (the reference's trace probe).
TRACE_COUNTS: "collections.Counter[str]" = collections.Counter()


class AdmissionQueueFull(RuntimeError):
    """``submit`` on an engine whose bounded admission queue
    (``ServeConfig.max_queued``) is full: typed backpressure instead of an
    unbounded backlog behind the tick loop."""

    def __init__(self, queued: int, capacity: int):
        super().__init__(f"admission queue full: {queued} queued >= max_queued "
                         f"{capacity} — retry later or raise max_queued")
        self.queued = queued
        self.capacity = capacity


class _AdmissionQueue:
    """Thread-safe waiting set that the scheduler picks from by policy, not
    position: ``submit`` appends from any thread, the tick thread takes a
    snapshot, chooses a candidate and removes it. Requests aborted while
    queued are pruned on every size or snapshot read."""

    def __init__(self):
        self._lock = threading.Lock()
        self._items: List["Request"] = []

    def put(self, req: "Request") -> None:
        with self._lock:
            self._items.append(req)

    def _prune_locked(self) -> None:
        self._items = [r for r in self._items if not r.done]

    def qsize(self) -> int:
        with self._lock:
            self._prune_locked()
            return len(self._items)

    def empty(self) -> bool:
        return self.qsize() == 0

    def snapshot(self) -> List["Request"]:
        with self._lock:
            self._prune_locked()
            return list(self._items)

    def remove(self, req: "Request") -> bool:
        with self._lock:
            try:
                self._items.remove(req)
                return True
            except ValueError:
                return False

    def drain(self) -> List["Request"]:
        with self._lock:
            items, self._items = self._items, []
            return [r for r in items if not r.done]


@dataclasses.dataclass
class PreemptedState:
    """What resumes a preempted request byte-exactly into any slot: its
    retained page runs (the K/V never moves; resuming rewrites a page-table
    row), the snapshot of its per-slot rows at the preemption position, and
    its host registers."""

    req: "Request"
    phase: str                          # ENCODE | PREFILL | DECODE
    offset: int                         # prompt tokens consumed
    length: int                         # cache length (tokens written)
    pages: List[int]                    # retained pool pages, in order
    snapshot: object                    # per-slot state tree (None: stateless)
    snaps: Dict[int, object]            # captured trie-boundary snapshots
    need_snaps: set                     # boundaries still to capture
    count: int                          # emitted tokens == the sampler's index
    last_token: int                     # decode input token at preemption
    xpages: List[int] = dataclasses.field(default_factory=list)
    # retained cross-pool pages (read-only after encode)
    enc_len: int = 0                    # valid encoder rows behind xpages


def _cache_leaves(caches) -> Dict[str, torch.Tensor]:
    """name -> leaf of the engine's caches: a list of segment trees
    (DecoderLM; ``caches[i].path``) or one tree (EncDecModel; ``caches.path``)."""
    trees = ({f"[{i}]": c for i, c in enumerate(caches)}
             if isinstance(caches, list) else {"": caches})
    return {f"caches{i}.{'.'.join(p)}": v
            for i, c in trees.items() for p, v in mod.walk(c)}


def _check_in_place(caches, returned, what: str) -> None:
    """Every cache is written in place (the pools by nn/attention.
    scatter_pages, the per-slot leaves by the model's layer walk): a model
    must hand back the very tensors the engine holds, which its captured
    graphs read and write. Walks nested (pattern) caches."""
    got = _cache_leaves(returned)
    for name, v in _cache_leaves(caches).items():
        if got.get(name) is not v:
            raise RuntimeError(f"{what}: the model returned a new {name} "
                               f"cache tensor; the engine's caches must be "
                               f"written in place")


def _map_snapshot(fn, tree):
    """``fn`` over the tensors of a snapshot tree (segment lists, pattern
    dicts, None for a block without per-slot state)."""
    if isinstance(tree, list):
        return [_map_snapshot(fn, t) for t in tree]
    if isinstance(tree, dict):
        return {k: _map_snapshot(fn, v) for k, v in tree.items()}
    return None if tree is None else fn(tree)


def _snapshot_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a snapshot tree, in one order for one structure."""
    if isinstance(tree, list):
        return [t for x in tree for t in _snapshot_leaves(x)]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _snapshot_leaves(tree[k])]
    return [] if tree is None else [tree]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (len,) int32
    params: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    finish_reason: Optional[str] = None  # "eos" | "length" | "aborted"
    admit_step: Optional[int] = None     # engine tick of admission
    token_steps: List[int] = dataclasses.field(default_factory=list)
    # engine tick at which each output token was emitted
    prefix_hit_tokens: int = 0           # prompt tokens served from the
    # prefix cache at admission (page-aligned; 0 on a miss)
    priority: str = "batch"              # resolved class (submit() fills it)
    submit_step: int = 0                 # engine tick at submission (the
    # per-class TTFT counts from here, queue wait included)
    preempt_count: int = 0               # times preempted so far
    frames: Optional[np.ndarray] = None  # (enc_len, d_model) f32 source
    # frames of an encoder-decoder request
    enc_digest: Optional[bytes] = None   # blake2b of the frames: the
    # EncoderCache key
    enc_reused: bool = False             # ENCODE skipped by an EncoderCache hit
    span: Optional[RequestSpan] = None   # wall-clock lifecycle (telemetry on)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    n_slots: int = 4
    max_len: int = 256                  # cache capacity per slot
    chunk_tokens: int = 32              # extend width == per-tick token budget
    temperature: float = 0.0
    top_k: Optional[int] = None
    seed: int = 0
    page_tokens: int = 16               # attention KV pool page size
    pool_pages: Optional[int] = None    # pool capacity; None: the
    # dense-equivalent n_slots * (max_len // page_tokens)
    prefix_cache: bool = False          # radix-trie shared-prefix reuse (the
    # EncoderCache for a cross model)
    prefix_nodes: int = 512             # trie node cap (snapshots hold
    # device memory for the stateful families)
    max_queued: Optional[int] = None    # admission-queue capacity; a full
    # queue makes submit() raise AdmissionQueueFull. None: unbounded
    priorities: bool = False            # class-aware, prefix-aware admission
    # order (off: strict FIFO)
    preempt: bool = False               # preempt-and-resume of strictly
    # lower-class slots for a waiting higher-class request; needs priorities
    default_priority: str = "batch"     # class of requests that name none
    starvation_limit: int = 8           # priority mode's aging floor: the most
    # consecutive admissions that may overtake the oldest waiter
    max_preempts: int = 3               # per-request preemption cap
    compute_path: str = "float"         # dense serve compute: "float" |
    # "int8" | "xnor" (kernels/tiled_xnor.py); the model must be built with
    # the same ModelContext.compute_path (the engine checks)
    enc_tokens: Optional[int] = None    # encoder-decoder models: padded
    # encoder width (the encode tick's one shape) and the cap on a
    # request's frame count; None resolves to max_len in the engine
    cross_pages: Optional[int] = None   # cross-attention pool capacity;
    # None: (n_slots + 1) * ceil(enc_tokens / page_tokens), the reference's
    enc_cache_entries: int = 128        # EncoderCache entry cap (LRU)
    telemetry: bool = True              # metrics, spans, tick phase timing
    # and the eager-tick detector; observation only (tokens are the same)
    trace_events: int = 0               # trace-event ring capacity; 0: none

    def __post_init__(self):
        if self.n_slots < 1:
            raise ValueError(f"n_slots must be >= 1: {self.n_slots}")
        if self.max_len < 1:
            raise ValueError(f"max_len must be >= 1: {self.max_len}")
        if self.chunk_tokens <= 0:
            raise ValueError(f"chunk_tokens must be positive: {self.chunk_tokens}")
        if self.chunk_tokens > self.max_len:
            raise ValueError(f"chunk_tokens {self.chunk_tokens} exceeds max_len "
                             f"{self.max_len}: a chunk could not fit the cache")
        if self.page_tokens <= 0:
            raise ValueError(f"page_tokens must be positive: {self.page_tokens}")
        if self.max_len % self.page_tokens:
            raise ValueError(f"page_tokens {self.page_tokens} must divide max_len "
                             f"{self.max_len}: the per-slot page-table view must "
                             f"be exactly the dense cache layout")
        if (self.pool_pages is not None
                and self.pool_pages < self.max_len // self.page_tokens):
            raise ValueError(f"pool_pages {self.pool_pages} is below one slot's "
                             f"worth ({self.max_len // self.page_tokens} pages): "
                             f"no sequence could reach max_len")
        if self.prefix_nodes < 1:
            raise ValueError(f"prefix_nodes must be >= 1: {self.prefix_nodes}")
        if self.max_queued is not None and self.max_queued < 1:
            raise ValueError(f"max_queued must be >= 1 (or None for "
                             f"unbounded): {self.max_queued}")
        if self.preempt and not self.priorities:
            raise ValueError("preempt=True requires priorities=True: FIFO "
                             "admission would hand the freed slot to the "
                             "oldest request instead and thrash")
        if self.default_priority not in PRIORITY_RANKS:
            raise ValueError(f"default_priority {self.default_priority!r} is not "
                             f"a priority class: {sorted(PRIORITY_RANKS)}")
        if self.starvation_limit < 1:
            raise ValueError(f"starvation_limit must be >= 1: "
                             f"{self.starvation_limit} (0 is FIFO; use "
                             f"priorities=False)")
        if self.max_preempts < 0:
            raise ValueError(f"max_preempts must be >= 0: {self.max_preempts}")
        if self.enc_tokens is not None and self.enc_tokens < 1:
            raise ValueError(f"enc_tokens must be >= 1 (or None for max_len): "
                             f"{self.enc_tokens}")
        if self.cross_pages is not None and self.cross_pages < 1:
            raise ValueError(f"cross_pages must be >= 1 (or None for the "
                             f"default): {self.cross_pages}")
        if self.enc_cache_entries < 1:
            raise ValueError(f"enc_cache_entries must be >= 1: "
                             f"{self.enc_cache_entries}")
        if self.trace_events < 0:
            raise ValueError(f"trace_events must be >= 0 (0 disables the "
                             f"ring): {self.trace_events}")
        if self.trace_events and not self.telemetry:
            raise ValueError("trace_events requires telemetry=True: the trace "
                             "ring is fed from the telemetry call sites")
        check_compute_path(self.compute_path)


class BatchedEngine:
    """Serves ``model`` (a SERVE-mode ``DecoderLM`` or ``EncDecModel``, any
    model of the ServableModel contract) from ``params`` on the model's
    device; the params must already live there. Under ``mesh`` the engine
    keeps this rank's block of them."""

    def __init__(self, model, params, cfg: ServeConfig, *, mesh=None):
        ensure_servable(model)
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
        self.mesh = mesh
        # the tick control: the first rank admits, the others mirror it
        self._control: Optional[TickControl] = None
        self._mirror: Dict[int, Request] = {}   # a follower's open requests
        if mesh is not None:
            params = place_params(params, mod.logical_axes(model.specs()), mesh)
            self._control = TickControl(mesh)
        self.params = params
        self.cfg = cfg
        self._queue = _AdmissionQueue()
        self._live: Dict[int, Request] = {}
        # preempted requests waiting to resume: pages retained, per-slot
        # rows snapshotted, no slot
        self._parked: List[PreemptedState] = []
        self._overtakes = 0                 # consecutive non-oldest admissions
        self._preempted_since_tick = False
        self._class_ttft: Dict[str, List[int]] = {}   # class -> [sum, n]
        self._free = list(range(cfg.n_slots))
        self._rid = itertools.count()
        self._phase: List[Optional[str]] = [None] * cfg.n_slots
        self._offsets = np.zeros((cfg.n_slots,), np.int64)
        self._admit_order: List[int] = []

        self.pt = cfg.page_tokens
        self.npp = cfg.max_len // self.pt
        n_pages = cfg.pool_pages or cfg.n_slots * self.npp
        # a page pool only for full attention (reference engine)
        self.pool = KVPool(n_pages, self.pt) if model.has_full_attn else None
        self._ptab = np.zeros((cfg.n_slots, self.npp), np.int32)
        self._n_mapped = np.zeros((cfg.n_slots,), np.int64)
        # the cross-attention family: a second pool with its own page-table
        # rows, written once a request by the encode tick, then read-only
        self._cross = model.has_cross_attn
        cache_kw = {}
        if self._cross:
            self.enc_tokens = cfg.enc_tokens or cfg.max_len
            self.x_npp = -(-self.enc_tokens // self.pt)
            x_pages = cfg.cross_pages or (cfg.n_slots + 1) * self.x_npp
            if x_pages < self.x_npp:
                raise ValueError(
                    f"cross_pages {x_pages} is below one request's worth "
                    f"({self.x_npp} pages for enc_tokens={self.enc_tokens})")
            self.xpool = KVPool(x_pages, self.pt, family="cross_attn")
            self._xptab = np.zeros((cfg.n_slots, self.x_npp), np.int32)
            self._xn_mapped = np.zeros((cfg.n_slots,), np.int64)
            self._enc_lens = np.zeros((cfg.n_slots,), np.int32)
            cache_kw["cross_pages"] = x_pages
        else:
            self.enc_tokens, self.x_npp, self.xpool = None, 0, None
        # the shared-prefix trie; a cross model's self-attention K/V depends
        # on its source, so it reuses encoder outputs instead
        self.trie = (PrefixTrie(self.pt, pool=self.pool, max_nodes=cfg.prefix_nodes)
                     if cfg.prefix_cache and not self._cross else None)
        self.enc_cache = (EncoderCache(self.xpool, max_entries=cfg.enc_cache_entries)
                          if cfg.prefix_cache and self._cross else None)
        # float pools and rings take the model's compute dtype (reference
        # engine); an int8 KV config allocates int8 codes and f32 scales
        # whatever it is, and recurrent carries are f32. Built under the
        # mesh's rules: a "heads" architecture's pools hold the rank's
        # block of the K/V heads, a "seq" architecture's pools and rings
        # the rank's time rows (nn/attention.py); the page allocator, the
        # trie, snapshots and the tick control see the same page ids on
        # every rank
        with self._mesh_ctx():
            self.caches = model.init_caches(cfg.n_slots, cfg.max_len,
                                            model.ctx.compute_dtype,
                                            page_tokens=self.pt, n_pages=n_pages,
                                            **cache_kw)
            # the rank's block of the slots (None: every slot)
            self._slots = slot_sharding(cfg.n_slots)
        self._stateful = model.has_recurrent_state
        # captured boundary snapshots per slot, and the boundaries of its
        # prompt that still need one (computed at admission)
        self._snaps: List[Dict[int, object]] = [{} for _ in range(cfg.n_slots)]
        self._need_snaps: List[set] = [set() for _ in range(cfg.n_slots)]
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
        # the slot that reset_slot zeroes, snapshot_slot reads and
        # restore_slot writes; n_slots (no slot) outside those calls
        self._slot_t = torch.full((), cfg.n_slots, dtype=torch.int64,
                                  device=self.device)
        # the snapshot restore_slot writes: one slot's per-slot rows, filled
        # from a trie node or a parked request before each restore
        self._snap_in = (model.snapshot_slot_caches(self.caches, 0)
                         if self._stateful else None)
        # the model's keywords of every tick: a decoder LM's the caches'
        # layout (a "seq" architecture's rank reads its rows by it); a cross
        # model's tick inputs: the cross page table and encoder lengths of
        # every slot (decode, extend), and the encode tick's padded frames,
        # their mask and the encoding slot's table row
        self._tick_kw: Dict[str, Any] = dict(page_tokens=cfg.page_tokens,
                                             max_len=cfg.max_len)
        if self._cross:
            dev, d = self.device, model.cfg.d_model
            self._xptab_t = torch.zeros((cfg.n_slots, self.x_npp),
                                        dtype=torch.int32, device=dev)
            self._enc_lens_t = torch.zeros((cfg.n_slots,), dtype=torch.int32,
                                           device=dev)
            self._tick_kw = {"cross_page_table": self._xptab_t,
                             "enc_lens": self._enc_lens_t}
            self._frames_t = torch.zeros((1, self.enc_tokens, d),
                                         dtype=model.ctx.compute_dtype, device=dev)
            self._valid_t = torch.zeros((1, self.enc_tokens), dtype=torch.bool,
                                        device=dev)
            self._xrow_t = torch.zeros((1, self.x_npp), dtype=torch.int32,
                                       device=dev)
            self._enc_pos_t = torch.arange(self.enc_tokens, device=dev)[None, :]
        self._graphs: Dict[str, TickGraph] = {}
        self._warm_s: Dict[str, float] = {}
        # per-slot sampling state, host side
        self._temps = np.zeros((cfg.n_slots,), np.float64)
        self._topks = np.zeros((cfg.n_slots,), np.int64)
        self._eos_ids = np.full((cfg.n_slots,), -1, np.int64)
        self._streams: List[tuple] = [()] * cfg.n_slots
        self._counts = np.zeros((cfg.n_slots,), np.int64)
        self._stats = {
            "admitted": 0, "prefix_hits": 0, "prefix_tokens": 0,
            "prompt_tokens": 0, "tokens_out": 0, "aborted": 0, "rejected": 0,
            "peak_queue_depth": 0, "preempt_free_ticks": 0, "work_ticks": 0,
            "preempts": 0, "resumes": 0, "preempted_tokens": 0,
            "enc_cache_hits": 0, "extend_ticks": 0, "decode_ticks": 0,
            "encode_ticks": 0}
        self._phase_s = {"extend": 0.0, "decode": 0.0, "encode": 0.0}
        self.steps = 0

        # streaming hooks: on_token(req, tok) the moment a tick emits a
        # token (it runs on the tick's thread and must be cheap);
        # on_finish(req) exactly once per request, aborts included
        self.on_token: Optional[Callable[[Request, int], None]] = None
        self.on_finish: Optional[Callable[[Request], None]] = None

        # telemetry: counter bumps, span transitions and host clock reads,
        # nothing that feeds back into scheduling or sampling
        self.tel: Optional[EngineTelemetry] = (
            EngineTelemetry(trace_events=cfg.trace_events).bind_engine(self)
            if cfg.telemetry else None)
        self._tick_phases: Dict[str, float] = {}
        # the eager-tick detector, armed by warmup(): a tick body that runs
        # during a step() instead of a graph replay moves TRACE_COUNTS. On
        # the CPU a warmed entry point's stand-in for a replay is the eager
        # body itself; those runs are counted apart and do not fire it.
        self._eager_armed = False
        self._eager_warned = False
        self._stand_in_runs = 0

    # ------------------------------------------------------------------
    def submit(self, prompt, params: Optional[SamplingParams] = None,
               frames=None) -> Request:
        """Queue a request. An encoder-decoder model needs ``frames``
        (enc_len, d_model), 0 < enc_len <= enc_tokens; any other model
        takes none. Raises ``AdmissionQueueFull`` on a full bounded queue."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or len(prompt) == 0:
            raise ValueError("prompt must be a non-empty 1-D token sequence")
        if len(prompt) > self.cfg.max_len:
            raise ValueError(
                f"prompt len {len(prompt)} exceeds max_len {self.cfg.max_len}")
        enc_digest = None
        if self._cross:
            if frames is None:
                raise ValueError(
                    "encoder-decoder serving: submit() needs frames "
                    "(enc_len, d_model) source embeddings alongside the "
                    "decoder prompt")
            frames = np.ascontiguousarray(np.asarray(frames, np.float32))
            if frames.ndim != 2 or frames.shape[1] != self.model.cfg.d_model:
                raise ValueError(
                    f"frames must be (enc_len, d_model="
                    f"{self.model.cfg.d_model}): got {frames.shape}")
            if not 0 < frames.shape[0] <= self.enc_tokens:
                raise ValueError(
                    f"frame count {frames.shape[0]} outside "
                    f"(0, enc_tokens={self.enc_tokens}]")
            # digest over shape and bytes: the EncoderCache key
            enc_digest = hashlib.blake2b(
                np.int64(frames.shape[0]).tobytes() + frames.tobytes(),
                digest_size=16).digest()
        elif frames is not None:
            raise ValueError(
                f"{type(self.model).__name__} has no encoder: frames are "
                f"only accepted for encoder-decoder models")
        params = params or SamplingParams()
        cls = (params.priority if params.priority is not None
               else self.cfg.default_priority)
        if cls not in PRIORITY_RANKS:
            raise ValueError(f"unknown priority class {cls!r}: expected one of "
                             f"{sorted(PRIORITY_RANKS)}")
        self._check_leader("submit")
        queued = self._queue.qsize() + (self._control.n_pending()
                                        if self._control is not None else 0)
        if self.cfg.max_queued is not None and queued >= self.cfg.max_queued:
            self._stats["rejected"] += 1
            if self.tel is not None:
                self.tel.rejected.inc()
            raise AdmissionQueueFull(queued, self.cfg.max_queued)
        req = self._new_request(next(self._rid), prompt, params, cls,
                                self.steps, frames, enc_digest)
        if self._control is not None:
            # queued when the next tick's message goes out, on every rank
            self._control.record(("submit", req.rid, prompt, params, cls,
                                  req.submit_step, frames, enc_digest), req)
        else:
            self._queue.put(req)
        return req

    def _new_request(self, rid, prompt, params, cls, step, frames,
                     enc_digest) -> Request:
        req = Request(rid=rid, prompt=prompt, params=params, priority=cls,
                      submit_step=step, frames=frames, enc_digest=enc_digest)
        if self.tel is not None:
            req.span = RequestSpan(req.rid, time.monotonic())
            self.tel.submitted.inc()
            if self.tel.ring is not None:
                self.tel.ring.emit("submit", rid=req.rid,
                                   prompt_tokens=len(prompt), priority=cls)
        return req

    @property
    def is_first(self) -> bool:
        """Whether this engine takes the calls: always without a mesh, on
        the mesh's first rank with one."""
        return self._control is None or self._control.is_first

    def _check_leader(self, what: str) -> None:
        if not self.is_first:
            raise RuntimeError(
                f"{what}() on a follower: under a mesh only its first rank "
                f"(rank {self._control.first}) takes submit / abort / "
                f"abort_all and steps; the other ranks run follow()")

    @property
    def has_work(self) -> bool:
        """Anything queued, live or parked (a parked request holds pages and
        an unfinished stream with no live slot), or submitted under a mesh
        for the next tick."""
        return (bool(self._live) or bool(self._parked) or not self._queue.empty()
                or (self._control is not None and self._control.n_pending() > 0))

    # ---- slot lifecycle ----------------------------------------------
    def _set_sampling(self, slot: int, req: Request) -> None:
        """Pin the request's resolved sampling params to the slot; an
        explicit seed roots its stream, else (engine seed, rid)."""
        res = req.params.resolve(self.cfg.temperature, self.cfg.top_k)
        self._temps[slot] = res.temperature
        self._topks[slot] = res.top_k
        self._eos_ids[slot] = res.eos_id
        self._streams[slot] = ((res.seed,) if res.seed is not None
                               else (self.cfg.seed, req.rid))

    def _clear_slot(self, slot: int) -> None:
        """Free the slot's host registers; its pages are the caller's."""
        self._snaps[slot] = {}
        self._need_snaps[slot] = set()
        self._live.pop(slot, None)
        self._free.append(slot)
        self._phase[slot] = None
        if slot in self._admit_order:
            self._admit_order.remove(slot)
        self._temps[slot] = 0.0
        self._topks[slot] = 0
        self._eos_ids[slot] = -1
        self._counts[slot] = 0

    def _admit(self, slot: int, req: Request):
        """O(1) admission: claim the slot and, with the prefix cache on, map
        the longest cached prefix in (its page run into the slot's table,
        refcounted; the deepest boundary snapshot over the freshly zeroed
        per-slot rows), so chunked prefill starts at the first uncached
        token."""
        self._live[slot] = req
        self._phase[slot] = PREFILL
        self._admit_order.append(slot)
        req.admit_step = self.steps
        boundary, path = 0, []
        if self.trie is not None:
            path = self.trie.match(req.prompt, require_snapshot=self._stateful,
                                   now=self.steps)
            boundary = len(path) * self.pt
        self._stats["admitted"] += 1
        self._stats["prompt_tokens"] += len(req.prompt)
        if boundary:
            self._stats["prefix_hits"] += 1
            self._stats["prefix_tokens"] += boundary
        req.prefix_hit_tokens = boundary
        if self.pool is not None:
            for i, node in enumerate(path):
                self.pool.retain(node.page)
                self._ptab[slot, i] = node.page
            self._n_mapped[slot] = len(path)
        self._snaps[slot] = {}
        self._need_snaps[slot] = (
            self._boundaries_needing_snapshots(req.prompt)
            if self.trie is not None and self._stateful else set())
        self._offsets[slot] = boundary
        self.lengths[slot] = boundary
        if self._stateful:
            # the paged pools need no device work at admission
            self._reset(slot)
            if boundary:
                self._restore(slot, path[-1].snapshot)
        self._set_sampling(slot, req)
        self._counts[slot] = 0
        if self._cross:
            # the request encodes its source before its prompt prefills,
            # unless the EncoderCache holds the source already
            self._enc_lens[slot] = len(req.frames)
            self._xn_mapped[slot] = 0
            self._phase[slot] = ENCODE
            self._try_enc_cache(slot, req)
        if self.tel is not None and req.span is not None:
            now = time.monotonic()
            req.span.mark_admit(now, self._phase[slot])
            self.tel.queue_wait.observe(now - req.span.submit_t)
            if self.tel.ring is not None:
                self.tel.ring.emit("admit", rid=req.rid, slot=slot,
                                   prefix_hit_tokens=boundary,
                                   phase=self._phase[slot])

    def _try_enc_cache(self, slot: int, req: Request) -> bool:
        """A warm source: map the cached encoder output's page run into the
        slot's cross table and skip the ENCODE phase."""
        if self.enc_cache is None or req.enc_digest is None:
            return False
        entry = self.enc_cache.get(req.enc_digest, now=self.steps)
        if entry is None:
            return False
        for i, pid in enumerate(entry.pages):
            self._xptab[slot, i] = pid
        self._xn_mapped[slot] = len(entry.pages)
        self._enc_lens[slot] = entry.enc_len
        self._phase[slot] = PREFILL
        req.enc_reused = True
        self._stats["enc_cache_hits"] += 1
        # a LATE hit (resolved by step(), not at admission) ends the span's
        # encode interval; at admission _admit names the resolved phase
        if req.span is not None and req.span.admit_t is not None:
            req.span.to_phase(PREFILL, time.monotonic())
        return True

    def _maybe_retire(self, slot: int, req: Request, tok: int) -> bool:
        """EOS before the length cap; the cache-capacity cap retires a
        sequence whose next decode step would write past max_len.
        Retirement publishes the prompt's complete pages (and boundary
        snapshots) into the trie, then drops the slot's references."""
        if tok == int(self._eos_ids[slot]):
            req.finish_reason = "eos"
        elif len(req.output) >= req.params.max_tokens:
            req.finish_reason = "length"
        elif len(req.prompt) + len(req.output) > self.cfg.max_len:
            req.finish_reason = "length"
        else:
            return False
        req.done = True
        if self.trie is not None:
            n_pub = len(req.prompt) // self.pt
            if n_pub:
                pages = ([int(self._ptab[slot, i]) for i in range(n_pub)]
                         if self.pool is not None else None)
                self.trie.insert(req.prompt[: n_pub * self.pt], pages,
                                 self._snaps[slot], now=self.steps)
        self._release_slot(slot)
        self._finish_telemetry(req)
        if self.on_finish is not None:
            self.on_finish(req)
        return True

    def _finish_telemetry(self, req: Request):
        """Close the request's span and record its end-of-life metrics
        (once: an abort racing a natural finish observes one)."""
        tel, span = self.tel, req.span
        if tel is None or span is None or span.finish_t is not None:
            return
        span.finish(time.monotonic(), req.finish_reason)
        tel.finished.labels(reason=req.finish_reason).inc()
        tel.e2e.observe(span.wall)
        if tel.ring is not None:
            tel.ring.emit("finish", rid=req.rid, reason=req.finish_reason,
                          tokens=len(req.output), wall_s=round(span.wall, 6),
                          phases={k: round(v, 6) for k, v in span.phases.items()})

    def _release_slot(self, slot: int):
        """Return a slot and every page it maps to the free pools (the
        tail of retirement and abort); pages the trie or the EncoderCache
        pin survive through their reference."""
        if self.pool is not None:
            for i in range(int(self._n_mapped[slot])):
                self.pool.release(int(self._ptab[slot, i]))
        self._n_mapped[slot] = 0
        if self.xpool is not None:
            for i in range(int(self._xn_mapped[slot])):
                self.xpool.release(int(self._xptab[slot, i]))
            self._xn_mapped[slot] = 0
            self._enc_lens[slot] = 0
        self._clear_slot(slot)

    def abort(self, req: Request) -> bool:
        """Cancel a queued, live or parked request: its slot and pages free
        at once, nothing is published to the trie (a half-prefilled page
        run would poison later hits), and ``on_finish`` fires with
        ``finish_reason == "aborted"``. Not safe against a concurrent
        ``step()``. False if the request already finished. Under a mesh the
        other ranks abort it at the start of the next tick."""
        self._check_leader("abort")
        done = self._abort(req)
        if done and self._control is not None:
            self._control.record(("abort", req.rid))
        return done

    def _abort(self, req: Request) -> bool:
        if req.done:
            return False
        req.done = True
        req.finish_reason = "aborted"
        self._stats["aborted"] += 1
        for slot, r in list(self._live.items()):
            if r is req:
                self._release_slot(slot)
                break
        else:
            for parked in self._parked:
                if parked.req is req:
                    self._release_parked(parked)
                    break
        # a queued request drops out of the waiting set at the next prune
        self._finish_telemetry(req)
        if self.on_finish is not None:
            self.on_finish(req)
        return True

    def abort_all(self) -> int:
        """Abort every live, parked and queued request (under a mesh also
        those submitted for the next tick); returns how many actually
        finished by it."""
        self._check_leader("abort_all")
        n = 0
        for r in list(self._live.values()):
            n += bool(self.abort(r))
        for parked in list(self._parked):
            n += bool(self.abort(parked.req))
        for r in self._queue.drain():
            n += bool(self.abort(r))
        if self._control is not None:
            for r in self._control.pending_requests():
                n += bool(self.abort(r))
        return n

    def _release_parked(self, parked: PreemptedState):
        """Drop a parked request's pages and snapshots: the inverse of the
        retain in place that ``preempt_slot`` made."""
        if self.pool is not None:
            for pid in parked.pages:
                self.pool.release(pid)
        if self.xpool is not None:
            for pid in parked.xpages:
                self.xpool.release(pid)
        parked.pages, parked.xpages = [], []
        parked.snapshot, parked.snaps = None, {}
        self._parked.remove(parked)

    # ---- scheduling under pressure -----------------------------------
    def preempt_slot(self, slot: int) -> bool:
        """Park the request in ``slot`` and free the slot, keeping all its
        progress: its pages stay retained, its per-slot rows are
        snapshotted at the current position, and its host registers
        (offset, length, last token, emitted count, pending boundary
        snapshots) ride in a :class:`PreemptedState`. The preempt pass
        calls it; tests call it to preempt at any tick. Not safe against a
        concurrent ``step()``. False if the slot is not live."""
        req = self._live.get(slot)
        if req is None:
            return False
        snap = self._snapshot(slot) if self._stateful else None
        parked = PreemptedState(
            req=req, phase=self._phase[slot], offset=int(self._offsets[slot]),
            length=int(self.lengths[slot]),
            pages=([int(self._ptab[slot, i])
                    for i in range(int(self._n_mapped[slot]))]
                   if self.pool is not None else []),
            snapshot=snap, snaps=self._snaps[slot],
            need_snaps=self._need_snaps[slot], count=int(self._counts[slot]),
            last_token=int(self.tokens[slot, 0]),
            xpages=([int(self._xptab[slot, i])
                     for i in range(int(self._xn_mapped[slot]))]
                    if self.xpool is not None else []),
            enc_len=int(self._enc_lens[slot]) if self.xpool is not None else 0)
        self._parked.append(parked)
        req.preempt_count += 1
        # free the slot without releasing its pages (the parked record owns
        # them now) and without on_finish
        self._n_mapped[slot] = 0
        if self.xpool is not None:
            self._xn_mapped[slot] = 0
            self._enc_lens[slot] = 0
        self._clear_slot(slot)
        self._stats["preempts"] += 1
        self._stats["preempted_tokens"] += parked.length
        self._preempted_since_tick = True
        if self.tel is not None:
            self.tel.preempts.inc()
            if req.span is not None:
                req.span.to_phase(PARKED, time.monotonic())
            if self.tel.ring is not None:
                self.tel.ring.emit("preempt", rid=req.rid, slot=slot,
                                   phase=parked.phase, tokens_kept=parked.length)
        return True

    def _resume(self, slot: int, parked: PreemptedState):
        """Restore a parked request into ``slot`` byte-exactly: its page
        runs back into the slot's table rows, its snapshot over the zeroed
        per-slot rows, its host registers verbatim (the emitted count is
        the sampler's token index, so a seeded stochastic stream goes on
        where it stopped)."""
        req = parked.req
        self._live[slot] = req
        self._phase[slot] = parked.phase
        if parked.phase in (PREFILL, ENCODE):
            self._admit_order.append(slot)
        if self.pool is not None:
            for i, pid in enumerate(parked.pages):
                self._ptab[slot, i] = pid
            self._n_mapped[slot] = len(parked.pages)
        if self.xpool is not None:
            for i, pid in enumerate(parked.xpages):
                self._xptab[slot, i] = pid
            self._xn_mapped[slot] = len(parked.xpages)
            self._enc_lens[slot] = parked.enc_len
        self._snaps[slot] = parked.snaps
        self._need_snaps[slot] = parked.need_snaps
        self._offsets[slot] = parked.offset
        self.lengths[slot] = parked.length
        if self._stateful:
            self._reset(slot)
            if parked.snapshot is not None:
                self._restore(slot, parked.snapshot)
        self._set_sampling(slot, req)
        self._counts[slot] = parked.count
        self.tokens[slot, 0] = parked.last_token
        self._stats["resumes"] += 1
        if self.tel is not None:
            self.tel.resumes.inc()
            if req.span is not None:
                req.span.to_phase(parked.phase, time.monotonic())
            if self.tel.ring is not None:
                self.tel.ring.emit("resume", rid=req.rid, slot=slot,
                                   phase=parked.phase)

    @staticmethod
    def _rank(req: Request) -> int:
        return PRIORITY_RANKS[req.priority]

    @staticmethod
    def _cand_rid(cand: Union[Request, PreemptedState]) -> int:
        return (cand.req if isinstance(cand, PreemptedState) else cand).rid

    def _candidate_key(self, cand: Union[Request, PreemptedState]):
        """Priority-mode order: (class rank, uncached prefill tokens,
        submission). A parked decode costs 0, a parked prefill resumes at
        its offset, a fresh request's cached prefix is probed from the trie
        without touching its recency, and an encode is charged unless the
        EncoderCache holds the source."""
        if isinstance(cand, PreemptedState):
            if cand.phase == ENCODE:
                cost = len(cand.req.prompt) + cand.enc_len
            elif cand.phase == PREFILL:
                cost = len(cand.req.prompt) - cand.offset
            else:
                cost = 0
            return (self._rank(cand.req), cost, cand.req.rid)
        cached = (self.trie.probe(cand.prompt, require_snapshot=self._stateful)
                  if self.trie is not None else 0)
        cost = len(cand.prompt) - cached
        if (self._cross and cand.frames is not None
                and not (self.enc_cache is not None
                         and cand.enc_digest in self.enc_cache)):
            cost += len(cand.frames)
        return (self._rank(cand), cost, cand.rid)

    def _pick_candidate(self, cands: List[Union[Request, PreemptedState]]):
        """The next admission from the waiting set (queued and parked).
        FIFO mode: the oldest submission. Priority mode: the best
        ``_candidate_key``, except that once ``starvation_limit``
        consecutive admissions overtook the oldest waiter, the oldest
        waiter goes next."""
        oldest = min(cands, key=self._cand_rid)
        if not self.cfg.priorities:
            return oldest
        if self._overtakes >= self.cfg.starvation_limit:
            choice = oldest
        else:
            choice = min(cands, key=self._candidate_key)
        self._overtakes = 0 if choice is oldest else self._overtakes + 1
        return choice

    def _admissions(self):
        """Fill free slots from the waiting set: resume parked requests
        and admit fresh ones under one ordering rule."""
        while self._free:
            cands = self._queue.snapshot() + self._parked
            if not cands:
                break
            choice = self._pick_candidate(cands)
            slot = self._free.pop(0)
            if isinstance(choice, PreemptedState):
                self._parked.remove(choice)
                self._resume(slot, choice)
            else:
                self._queue.remove(choice)
                self._admit(slot, choice)

    def _preempt_pass(self) -> int:
        """Park strictly lower-class slots for waiting higher-class
        requests. A victim's class must be worse than the best waiting
        overflow request's and it must be under ``max_preempts``; the worst
        class goes first, the latest admission breaking ties. Each parking
        frees a slot, so the overflow shrinks and the loop ends."""
        n = 0
        while True:
            waiting = self._queue.snapshot() + self._parked
            waiting.sort(key=self._candidate_key)
            overflow = waiting[len(self._free):]
            if not overflow:
                break
            best = min(self._rank(c.req if isinstance(c, PreemptedState) else c)
                       for c in overflow)
            victims = [s for s, r in self._live.items()
                       if self._rank(r) > best
                       and r.preempt_count < self.cfg.max_preempts]
            if not victims:
                break
            self.preempt_slot(max(victims, key=lambda s: (
                self._rank(self._live[s]), self._live[s].admit_step,
                self._live[s].rid)))
            n += 1
        return n

    # ------------------------------------------------------------------
    def _boundaries_needing_snapshots(self, prompt) -> set:
        """Page boundaries of ``prompt`` whose trie node is missing or has
        no snapshot: the only places prefill pauses at and snapshots. Once
        the walk falls off the trie every deeper boundary needs one."""
        need, node = set(), self.trie.root
        for i in range(len(prompt) // self.pt):
            if node is not None:
                node = node.children.get(
                    tuple(int(t) for t in prompt[i * self.pt:(i + 1) * self.pt]))
            if node is None or node.snapshot is None:
                need.add((i + 1) * self.pt)
        return need

    def _alloc_page(self) -> int:
        """A page from the pool, evicting LRU trie leaves on demand (a page
        a live slot shares frees only when that slot lets go, so the loop
        may evict several)."""
        pid = self.pool.alloc()
        while pid is None:
            if self.trie is None or not self.trie.evict_one():
                raise RuntimeError(
                    f"KV page pool exhausted ({self.pool.n_pages} pages, 0 "
                    f"free, {len(self.trie) if self.trie else 0} trie nodes): "
                    f"raise pool_pages")
            pid = self.pool.alloc()
        return pid

    def _alloc_xpage(self) -> int:
        """A cross-pool page, evicting LRU EncoderCache entries on demand."""
        pid = self.xpool.alloc()
        while pid is None:
            if self.enc_cache is None or not self.enc_cache.evict_one():
                raise RuntimeError(
                    f"cross-attention page pool exhausted ({self.xpool.n_pages} "
                    f"pages, 0 free, "
                    f"{len(self.enc_cache) if self.enc_cache else 0} cached "
                    f"encoder outputs): raise cross_pages")
            pid = self.xpool.alloc()
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

    def _schedule_prefill(self, n_decoding: int,
                          extra_charge: int = 0) -> Dict[int, int]:
        """Token-budget pass: chunk_tokens per tick, decode-priority; the
        head of the prefill queue always gets at least one token.
        ``extra_charge`` bills this tick's encode against the same budget.
        A chunk never crosses a boundary that still needs a snapshot, so
        the per-slot state right after it sits exactly there; boundaries
        the trie covers do not pause it."""
        c = self.cfg.chunk_tokens
        budget = c - n_decoding - extra_charge
        takes: Dict[int, int] = {}
        first = True
        for slot in self._admit_order:
            if self._phase[slot] != PREFILL:
                continue
            off = int(self._offsets[slot])
            take = min(c, len(self._live[slot].prompt) - off,
                       max(budget, 1 if first else 0))
            ahead = [b for b in self._need_snaps[slot] if b > off]
            if ahead:
                take = min(take, min(ahead) - off)
            first = False
            if take <= 0:
                continue
            takes[slot] = take
            budget -= take
        return takes

    def _rows(self, t: torch.Tensor) -> torch.Tensor:
        """The rank's slots' rows of a per-slot tensor (every row without a
        slot split)."""
        return t if self._slots is None else self._slots.local(t)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """The ids sampled from a tick's logits: every slot's, or under a
        slot split the rank's slots' (its rows of the logits)."""
        n = logits.shape[0]
        first = 0 if self._slots is None else self._slots.index * n
        rows = range(first, first + n)
        seeds = [row_seed(self._streams[s], int(self._counts[s]))
                 if self._temps[s] > 0 else None for s in rows]
        return sample_logits_batch(logits, self._temps[first:first + n],
                                   self._topks[first:first + n], seeds)

    def _mesh_ctx(self):
        """The sharding rules' context for a tick; a no-op without a mesh."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return axis_rules(self.mesh)

    def _agree(self, ids: torch.Tensor) -> torch.Tensor:
        """A tick's sampled ids of every slot, as the mesh's first rank holds
        them: a rank's rows gathered over the data axes under a slot split,
        then one broadcast a tick, so every rank emits the same tokens and
        keeps the same schedule; ``ids`` as given without a mesh."""
        if self.mesh is None:
            return ids
        if self._slots is not None:
            ids = self._slots.gather(ids, 0)
        return broadcast_from_first(ids.contiguous(), self.mesh)

    def _emit(self, slot: int, req: Request, tok: int):
        req.output.append(tok)
        req.token_steps.append(self.steps)
        if len(req.output) == 1:
            # per-class TTFT in ticks from submission (queue wait and
            # parked time included)
            acc = self._class_ttft.setdefault(req.priority, [0, 0])
            acc[0] += self.steps - req.submit_step
            acc[1] += 1
        self._counts[slot] += 1
        self._stats["tokens_out"] += 1
        tel = self.tel
        if tel is not None:
            tel.tokens.inc()
            if req.span is not None:
                now = time.monotonic()
                prev = req.span.last_token_t
                if req.span.token(now):
                    tel.ttft.observe(now - req.span.submit_t)
                else:
                    tel.itl.observe(now - prev)
        if self.on_token is not None:
            self.on_token(req, tok)

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
            active=active, **self._tick_kw)
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
            self._n_new_t, self._ptab_t, **self._tick_kw)
        _check_in_place(self.caches, caches, "extend_tick")
        self.lengths.copy_(lengths)
        return logits

    def _reset_slot(self) -> None:
        """Zero the per-slot cache rows of slot ``_slot_t`` (recurrent
        carries must restart from zeros; rings are cleared too); the paged
        pools are left alone. A slot index of n_slots zeroes nothing."""
        TRACE_COUNTS["reset_slot"] += 1
        _check_in_place(self.caches, self.model.reset_slot_caches(
            self.caches, self._slot_t, paged=True, n_slots=self.cfg.n_slots),
            "reset_slot")

    def _snapshot_slot(self):
        """Slot ``_slot_t``'s per-slot rows as a tree of new tensors (a
        graph's static output once captured: the caller clones it)."""
        TRACE_COUNTS["snapshot_slot"] += 1
        return self.model.snapshot_slot_caches(self.caches, self._slot_t,
                                               n_slots=self.cfg.n_slots)

    def _restore_slot(self) -> None:
        """Write ``_snap_in`` into slot ``_slot_t``'s per-slot rows, in
        place; a slot index of n_slots writes nothing."""
        TRACE_COUNTS["restore_slot"] += 1
        _check_in_place(self.caches, self.model.restore_slot_caches(
            self.caches, self._slot_t, self._snap_in, n_slots=self.cfg.n_slots),
            "restore_slot")

    def _encode_tick(self) -> None:
        """The ENCODE phase of one request: the padded (1, enc_tokens)
        encoder pass over ``_frames_t`` (``_valid_t`` marks the real
        frames), then each decoder layer's cross K/V scattered through the
        slot's cross table row ``_xrow_t``, in place. The only writer of
        cross pages; padded frames land on the scratch page."""
        TRACE_COUNTS["encode_tick"] += 1
        memory = self.model.encode_serve(self.params, self._frames_t,
                                         self._valid_t)
        _check_in_place(self.caches, self.model.write_cross(
            self.params, memory, self.caches, self._xrow_t, self._enc_pos_t,
            self._valid_t), "encode_tick")

    def _entry_points(self):
        """name -> (tick function, the static tensors it reads or writes
        besides the params). ``reset_slot`` only for a model with per-slot
        caches, with ``snapshot_slot`` and ``restore_slot`` when the prefix
        trie or preemption can need them; ``encode_tick`` only for a model
        with cross attention."""
        caches = _cache_leaves(self.caches)
        cross = ({"xptab": self._xptab_t, "enc_lens": self._enc_lens_t}
                 if self._cross else {})
        points = {
            "decode_tick": (self._decode_tick, {
                "tokens": self.tokens, "lengths": self.lengths,
                "ptab": self._ptab_t, "active": self._active_t, **cross,
                **caches}),
            "extend_tick": (self._extend_tick, {
                "block": self._block_t, "lengths": self.lengths,
                "n_new": self._n_new_t, "ptab": self._ptab_t, **cross,
                **caches}),
        }
        if self._stateful:
            points["reset_slot"] = (self._reset_slot,
                                    {"slot": self._slot_t, **caches})
            if self.trie is not None or self.cfg.preempt:
                snap_in = {f"snap{i}": t for i, t in
                           enumerate(_snapshot_leaves(self._snap_in))}
                points["snapshot_slot"] = (self._snapshot_slot,
                                           {"slot": self._slot_t, **caches})
                points["restore_slot"] = (self._restore_slot, {
                    "slot": self._slot_t, **snap_in, **caches})
        if self._cross:
            points["encode_tick"] = (self._encode_tick, {
                "frames": self._frames_t, "valid": self._valid_t,
                "xrow": self._xrow_t, **caches})
        return points

    def _tick(self, name: str):
        graph = self._graphs.get(name)
        if graph is not None:
            if graph.graph is None:
                self._stand_in_runs += 1    # the CPU's stand-in for a replay
            return graph.run()
        return getattr(self, f"_{name}")()

    def _reset(self, slot: int) -> None:
        self._slot_t.fill_(slot)
        self._tick("reset_slot")

    def _snapshot(self, slot: int):
        """Slot ``slot``'s per-slot rows as tensors the caller owns: a
        replay's static output is cloned, or the next replay would
        overwrite every snapshot taken so far."""
        self._slot_t.fill_(slot)
        snap = self._tick("snapshot_slot")
        graph = self._graphs.get("snapshot_slot")
        if graph is not None and graph.graph is not None:
            snap = _map_snapshot(torch.clone, snap)
        return snap

    def _restore(self, slot: int, snap) -> None:
        """Write ``snap`` into slot ``slot``'s per-slot rows through the
        static ``_snap_in`` buffer that the restore tick reads."""
        for held, given in zip(_snapshot_leaves(self._snap_in),
                               _snapshot_leaves(snap), strict=True):
            held.copy_(given)
        self._slot_t.fill_(slot)
        self._tick("restore_slot")

    def warmup(self) -> Dict[str, float]:
        """Capture the decode tick, the extend tick and, for a model with
        per-slot caches, the slot reset (with the prefix trie or
        preemption on, the slot snapshot and restore too), for one with
        cross attention the encode tick, for this engine's shapes (a CUDA
        graph each, sharing one memory pool; on the CPU one eager run each,
        no graph), so that serving replays them. Returns the seconds per
        entry point, warm-up runs included.

        The warm-up runs and the capture see every per-tick input zeroed:
        no slot active, no new tokens, no slot to reset, snapshot or
        restore, no valid frame. Every pool write then lands on the scratch
        page, every per-slot row keeps its value, and ``lengths`` and
        ``tokens`` stay as they were, so a mid-flight warmup changes no
        request. A second call is a no-op that returns the first call's
        seconds. Raises ``RuntimeError`` naming the entry point and its
        buffers' shapes if a run or a capture fails; the engine then stays
        cold (no quiet half warmup).

        Under a mesh the call is collective: every rank calls it at the same
        point of its schedule. Each entry point is captured as graphs split
        at its collectives (``serve/graphs.py``), which run eagerly between
        the replays, and every rank must record the same collectives (kind,
        mesh axis, shape, dtype): a ``RuntimeError`` names the first that
        differs."""
        if self._graphs:
            return dict(self._warm_s)
        self._ptab_t.copy_(torch.from_numpy(self._ptab))
        self._active_t.zero_()
        self._block_t.zero_()
        self._n_new_t.zero_()
        self._slot_t.fill_(self.cfg.n_slots)
        if self._cross:
            self._copy_cross_inputs()
            self._frames_t.zero_()
            self._valid_t.zero_()
            self._xrow_t.zero_()
        pool = (torch.cuda.graph_pool_handle() if self.device.type == "cuda"
                else None)
        graphs, timings = {}, {}
        split = self.mesh is not None
        with torch.no_grad(), self._mesh_ctx():
            for name, (fn, buffers) in self._entry_points().items():
                graphs[name] = TickGraph(name, fn, buffers, self.device,
                                         split=split)
                timings[name] = graphs[name].capture(pool)
                if split:
                    self._control.check_same(f"warmup of '{name}'",
                                             graphs[name].sequence)
        self._graphs, self._warm_s = graphs, timings
        # from here on a tick body that runs in step() is an eager tick
        self._eager_armed = True
        return dict(timings)

    @property
    def aot_warm(self) -> bool:
        return bool(self._graphs)

    # ------------------------------------------------------------------
    # host side of the ticks
    # ------------------------------------------------------------------
    def _copy_cross_inputs(self) -> None:
        """The cross page table and encoder lengths into their static
        buffers, before a decode or extend tick of a cross model."""
        if self._cross:
            self._xptab_t.copy_(torch.from_numpy(self._xptab))
            self._enc_lens_t.copy_(torch.from_numpy(self._enc_lens))

    def _run_encode(self, slot: int) -> int:
        """The slot's ENCODE phase: map its cross pages, run the encode
        tick over its frames padded to enc_tokens, publish the run to the
        EncoderCache and move the slot to PREFILL. Returns the charge
        against this tick's prefill budget."""
        t0 = time.perf_counter()
        req = self._live[slot]
        enc_len = int(self._enc_lens[slot])
        need = -(-enc_len // self.pt)
        while self._xn_mapped[slot] < need:
            self._xptab[slot, self._xn_mapped[slot]] = self._alloc_xpage()
            self._xn_mapped[slot] += 1
        frames = np.zeros(tuple(self._frames_t.shape), np.float32)
        frames[0, :enc_len] = req.frames
        valid = np.zeros((1, self.enc_tokens), bool)
        valid[0, :enc_len] = True
        self._frames_t.copy_(torch.from_numpy(frames))
        self._valid_t.copy_(torch.from_numpy(valid))
        self._xrow_t.copy_(torch.from_numpy(self._xptab[slot:slot + 1]))
        self._tick("encode_tick")
        self._phase[slot] = PREFILL
        self._stats["encode_ticks"] += 1
        if self.tel is not None:
            self.tel.encode_ticks.inc()
            if req.span is not None:
                req.span.to_phase(PREFILL, time.monotonic())
        if self.enc_cache is not None:
            self.enc_cache.put(req.enc_digest,
                               [int(self._xptab[slot, i]) for i in range(need)],
                               enc_len, now=self.steps)
        self._phase_s["encode"] += time.perf_counter() - t0
        return min(enc_len, self.cfg.chunk_tokens)

    def _run_extend(self, takes: Dict[int, int]):
        cfg, tel = self.cfg, self.tel
        t0 = time.perf_counter()
        block = np.zeros((cfg.n_slots, cfg.chunk_tokens), np.int64)
        n_new = np.zeros((cfg.n_slots,), np.int32)
        for slot, take in takes.items():
            off = int(self._offsets[slot])
            block[slot, :take] = self._live[slot].prompt[off:off + take]
            n_new[slot] = take
            self._ensure_pages(slot, off + take - 1)
        t_dev = time.perf_counter()
        self._block_t.copy_(torch.from_numpy(block))
        self._n_new_t.copy_(torch.from_numpy(n_new))
        self._ptab_t.copy_(torch.from_numpy(self._ptab))
        self._copy_cross_inputs()
        # the host copy of the sampled tokens ends the device phase
        toks_host = self._agree(self._sample(self._tick("extend_tick"))).tolist()
        t_host = time.perf_counter()
        if tel is not None:
            self._tick_phases["prefill_device"] = t_host - t_dev
            tel.prefill_tokens.inc(sum(takes.values()))
        for slot, take in takes.items():
            req = self._live[slot]
            self._offsets[slot] += take
            off_new = int(self._offsets[slot])
            if off_new in self._need_snaps[slot]:
                # prefill just landed on a boundary the trie lacks: pin the
                # per-slot state here for the node that retirement publishes
                self._snaps[slot][off_new] = self._snapshot(slot)
            if off_new == len(req.prompt):
                # prompt complete: the chunk's last-column logits give the
                # request's first token
                self._phase[slot] = DECODE
                self._admit_order.remove(slot)
                tok = toks_host[slot]
                if tel is not None and req.span is not None:
                    req.span.to_phase(DECODE, time.monotonic())
                self.tokens[slot, 0] = tok
                self._emit(slot, req, tok)
                self._maybe_retire(slot, req, tok)
        if tel is not None:
            self._tick_phases["prefill_host"] = time.perf_counter() - t_host
        self._stats["extend_ticks"] += 1
        self._phase_s["extend"] += time.perf_counter() - t0

    def _run_decode(self, decoding: List[int]):
        tel = self.tel
        t0 = time.perf_counter()
        active = np.zeros((self.cfg.n_slots,), bool)
        active[decoding] = True
        for slot in decoding:
            req = self._live[slot]
            pos = len(req.prompt) + len(req.output) - 1  # row this step writes
            if pos < self.cfg.max_len:
                self._ensure_pages(slot, pos)
        t_dev = time.perf_counter()
        self._active_t.copy_(torch.from_numpy(active))
        self._ptab_t.copy_(torch.from_numpy(self._ptab))
        self._copy_cross_inputs()
        logits = self._tick("decode_tick")
        nxt = self._agree(torch.where(self._rows(self._active_t), self._sample(logits),
                                      self._rows(self.tokens[:, 0])))
        self.tokens.copy_(nxt[:, None])
        nxt_host = nxt.tolist()
        t_host = time.perf_counter()
        if tel is not None:
            self._tick_phases["decode_device"] = t_host - t_dev
        for slot in decoding:
            req = self._live[slot]
            tok = nxt_host[slot]
            self._emit(slot, req, tok)
            self._maybe_retire(slot, req, tok)
        if tel is not None:
            self._tick_phases["decode_host"] = time.perf_counter() - t_host
        self._stats["decode_ticks"] += 1
        self._phase_s["decode"] += time.perf_counter() - t0

    def step(self):
        """One engine tick: the preempt pass, admissions and resumes, at
        most one ENCODE (cross models; a warm source maps in without one),
        scheduled prefill chunks, then one batched decode step. Every slot
        decoding at the start of the tick emits exactly one token; a
        prefilling slot emits its first token on the tick its last chunk
        lands; a slot preempted this tick emits nothing. Under a mesh the
        first rank first sends the calls since the last tick to the other
        ranks, which run the same tick in ``follow()``."""
        self._check_leader("step")
        if self._control is not None:
            for req in self._control.send():
                self._queue.put(req)
        self._step()

    def follow(self) -> int:
        """Run this rank of a mesh behind the first rank until it stops the
        followers (``stop_followers``): each message's calls applied in
        order, then the same tick. Returns the ticks run. On the first rank
        (or without a mesh) it raises."""
        if self._control is None or self._control.is_first:
            raise RuntimeError("follow() runs the mesh's other ranks; this "
                               "engine takes the calls itself")
        ticks = 0
        while True:
            calls, stop = self._control.receive()
            if stop:
                return ticks
            self._apply(calls)
            self._step()
            ticks += 1

    def stop_followers(self) -> None:
        """First rank: send the stop flag, which ends the other ranks'
        ``follow()``; this engine steps no more. Nothing without a mesh."""
        if self._control is not None:
            self._check_leader("stop_followers")
            self._control.send(stop=True)

    def _apply(self, calls) -> None:
        """A follower's copy of the first rank's calls, in their order."""
        for call in calls:
            if call[0] == "submit":
                rid, prompt, params, cls, step, frames, digest = call[1:]
                req = self._new_request(rid, prompt, params, cls, step,
                                        frames, digest)
                self._mirror[rid] = req
                self._queue.put(req)
            else:                           # ("abort", rid)
                self._abort(self._mirror[call[1]])
        self._mirror = {k: r for k, r in self._mirror.items() if not r.done}

    def _step(self):
        tel = self.tel
        with torch.no_grad(), self._mesh_ctx():
            if tel is not None:
                t_tick = time.perf_counter()
                eager_pre = self._eager_count() if self._eager_armed else 0
            if self.cfg.preempt:
                self._preempt_pass()
            if tel is not None:
                t_adm = time.perf_counter()
                self._tick_phases["preempt"] = t_adm - t_tick
            self._admissions()
            depth = self._queue.qsize()
            self._stats["peak_queue_depth"] = max(self._stats["peak_queue_depth"],
                                                  depth)
            if tel is not None:
                self._tick_phases["admission"] = time.perf_counter() - t_adm
            if not self._live:
                # an idle tick runs no tick function and observes nothing
                self._tick_phases.clear()
                return
            enc_charge = 0
            if self._cross:
                t_enc = time.perf_counter()
                for slot in list(self._admit_order):
                    if self._phase[slot] != ENCODE:
                        continue
                    if self._try_enc_cache(slot, self._live[slot]):
                        continue
                    enc_charge = self._run_encode(slot)
                    break
                if tel is not None and enc_charge:
                    self._tick_phases["encode"] = time.perf_counter() - t_enc
            decoding = [s for s in range(self.cfg.n_slots)
                        if self._phase[s] == DECODE]
            dec_reqs = [(self._live[s], len(self._live[s].output))
                        for s in decoding]
            takes = self._schedule_prefill(len(decoding), extra_charge=enc_charge)
            if takes:
                self._run_extend(takes)
            if decoding:
                self._run_decode(decoding)
            # a work tick is preempt-free iff no slot was preempted since
            # the last one and every slot that entered it decoding emitted
            self._stats["work_ticks"] += 1
            if (not self._preempted_since_tick
                    and all(len(r.output) == n + 1 for r, n in dec_reqs)):
                self._stats["preempt_free_ticks"] += 1
            self._preempted_since_tick = False
            if tel is not None:
                self._observe_tick(t_tick, eager_pre)
        self.steps += 1

    def _eager_count(self) -> int:
        """Tick bodies run so far that were not a warmed entry point's
        CPU stand-in for a replay."""
        return sum(TRACE_COUNTS.values()) - self._stand_in_runs

    def _observe_tick(self, t_tick: float, eager_pre: int):
        """End-of-tick telemetry: the tick and per-phase histograms, then
        the eager-tick check (a tick body that ran in this step() after
        warmup: an entry point that fell off its captured graph)."""
        tel = self.tel
        tel.tick.observe(time.perf_counter() - t_tick)
        for phase, dt in self._tick_phases.items():
            tel.tick_phase[phase].observe(dt)
        self._tick_phases.clear()
        if not self._eager_armed:
            return
        delta = self._eager_count() - eager_pre
        if delta <= 0:
            return
        tel.retraces.inc(delta)
        if tel.ring is not None:
            tel.ring.emit("retrace", tick=self.steps, n_traces=delta)
        if not self._eager_warned:
            self._eager_warned = True
            warnings.warn(
                f"serve engine ran {delta} tick function(s) eagerly at tick "
                f"{self.steps} after warmup(): an entry point is not "
                f"replaying its captured graph (see serve_retraces_total)",
                RuntimeWarning, stacklevel=2)

    def stats(self) -> Dict[str, object]:
        """Ticks, tokens, admissions, prefix hits and the prefill tokens
        they skipped, pool pages (also per cache family), queue pressure
        (depth, peak, typed rejects), preempts / resumes and the
        preempt-free tick rate, per-class TTFT in ticks, the compute path,
        whether the ticks replay captured graphs (``aot_warm``), and the
        mean wall time of the extend, decode and encode phases (host clock;
        the extend and decode phases end by copying their sampled tokens to
        the host, so they include the device work; an encode phase ends at
        its launch on a card). With telemetry on also the latency quantiles
        and the count of eager ticks after warmup (``retraces``)."""
        s = dict(self._stats)
        s["ticks"] = self.steps
        s["hit_rate"] = s["prefix_hits"] / max(s["admitted"], 1)
        s["prefill_tokens_skipped"] = s["prefix_tokens"]
        s["pool_pages"] = self.pool.n_pages if self.pool is not None else 0
        s["pages_in_use"] = self.pool.used_pages if self.pool is not None else 0
        s["page_utilization"] = (self.pool.utilization
                                 if self.pool is not None else 0.0)
        s["cache_families"] = {
            p.family: {"pages": p.n_pages, "in_use": p.used_pages,
                       "utilization": p.utilization}
            for p in (self.pool, self.xpool) if p is not None}
        s["enc_cache_entries"] = (len(self.enc_cache)
                                  if self.enc_cache is not None else 0)
        s["trie_nodes"] = len(self.trie) if self.trie is not None else 0
        s["evictions"] = self.trie.evictions if self.trie is not None else 0
        s["trie_snapshot_bytes"] = (self.trie.snapshot_bytes()
                                    if self.trie is not None else 0)
        s["queue_depth"] = self._queue.qsize()
        s["live_slots"] = len(self._live)
        s["free_slots"] = len(self._free)
        s["parked"] = len(self._parked)
        s["preempt_free_tick_rate"] = (s["preempt_free_ticks"]
                                       / max(s["work_ticks"], 1))
        s["class_ttft_ticks"] = {cls: round(total / n, 2) for cls, (total, n)
                                 in sorted(self._class_ttft.items())}
        s["class_counts"] = {cls: n for cls, (_, n)
                             in sorted(self._class_ttft.items())}
        s["compute_path"] = self.cfg.compute_path
        s["aot_warm"] = self.aot_warm
        for phase in ("extend", "decode", "encode"):
            n = s[f"{phase}_ticks"]
            s[f"{phase}_ms_mean"] = 1e3 * self._phase_s[phase] / n if n else 0.0
        if self.tel is not None:
            s["latency"] = self.tel.latency_summary()
            s["retraces"] = self.tel.retraces.get()
        return s

    def run_until_drained(self, max_steps: int = 10_000, on_tick=None) -> int:
        """Step until every submitted request completes; returns the tick
        count. ``on_tick(engine)`` runs after each tick."""
        self._check_leader("run_until_drained")
        for i in range(max_steps):
            if not self.has_work:
                return i
            self.step()
            if on_tick is not None:
                on_tick(self)
        slots = ", ".join(
            f"slot {s}: rid={r.rid} {self._phase[s]}"
            f"@{int(self._offsets[s])}/{len(r.prompt)}"
            f" ({len(r.output)}/{r.params.max_tokens} tok)"
            for s, r in sorted(self._live.items()))
        parked = ", ".join(
            f"rid={p.req.rid} parked {p.phase}@{p.offset}/{len(p.req.prompt)} "
            f"({len(p.req.output)} tok, preempted x{p.req.preempt_count})"
            for p in self._parked)
        raise RuntimeError(
            f"engine did not drain after {max_steps} steps: "
            f"{self._queue.qsize()} queued, {len(self._live)} live, "
            f"{len(self._parked)} parked — "
            f"{'; '.join(x for x in (slots, parked) if x) or 'no live slots'}")
