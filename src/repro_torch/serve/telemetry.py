"""Zero-dependency serving telemetry: metrics, spans, trace events (port of
``repro/serve/telemetry.py``, which is pure Python; the port keeps its own
copy).

* :class:`MetricsRegistry`: counters, gauges and fixed-bucket log-spaced
  histograms, cheap enough to update from the tick thread (an ``observe``
  is one bisect over ~40 edges and two adds), rendered on demand in the
  Prometheus text exposition format by ``render()``.
* :class:`RequestSpan`: one request's lifecycle, submit -> admit -> first
  token -> finish, every wall-clock moment in exactly one phase (``queue``,
  ``encode``, ``prefill``, ``decode``, ``parked``). The intervals are
  disjoint and cover [submit, finish], so ``sum(phases.values())`` is the
  wall time up to float error.
* :class:`TraceRing`: an optional bounded ring of structured trace events
  (submit / admit / preempt / resume / finish / retrace), drained to a
  JSON-lines file by the serve CLI's ``--trace-log``.
* :class:`EngineTelemetry`: the serving metric families plus the span and
  ring plumbing, bound to one engine.

Telemetry is OBSERVATION ONLY: nothing here feeds back into scheduling or
sampling, and the engine's tokens are byte-identical with it on or off. It
reads the host clock only; the engine adds no device synchronisation for
it (a tick's device phase ends at the host copy of its sampled tokens,
which the tick makes anyway).

Threading: each metric has one writer thread (the tick thread) and any
number of readers; writes are single bytecode-level int/float updates under
the GIL, so a reader may see a value one update stale, never a torn one.
Creating a label child is the only cross-thread mutation and takes the
family lock.

Names: ``serve_<noun>[_<unit>]``, ``_total`` for counters, ``_seconds`` for
duration histograms, bare nouns for gauges.
"""
from __future__ import annotations

import bisect
import collections
import re
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def log_buckets(lo: float, hi: float, per_decade: int = 6) -> Tuple[float, ...]:
    """Log-spaced histogram edges: ``per_decade`` buckets per factor of
    10, spanning [lo, hi]. Fixed at construction so ``observe`` is one
    bisect — no dynamic resizing on the tick thread."""
    if lo <= 0 or hi <= lo:
        raise ValueError(f"need 0 < lo < hi: ({lo}, {hi})")
    if per_decade < 1:
        raise ValueError(f"per_decade must be >= 1: {per_decade}")
    growth = 10.0 ** (1.0 / per_decade)
    edges, e = [], lo
    while e < hi * (1 + 1e-9):
        # 4 significant digits: "0.0001468", not "0.0001467799267622069" —
        # the exposition (le="...") and dashboards stay readable, and at
        # any sane per_decade the rounded edges stay strictly increasing
        edges.append(float(f"{e:.4g}"))
        e *= growth
    return tuple(edges)


# default duration edges: 10µs .. 100s — wide enough for a µs-scale tick
# phase and a multi-second cold TTFT in one family
DURATION_BUCKETS = log_buckets(1e-5, 100.0, per_decade=6)


def _fmt(v) -> str:
    """Exposition value/edge formatting: ints stay ints, floats use
    repr (shortest round-trip — '1e-05', not '0.00001')."""
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _label_str(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        '%s="%s"' % (k, v.replace("\\", r"\\").replace('"', r"\"")
                     .replace("\n", r"\n"))
        for k, v in labels
    )
    return "{" + inner + "}"


class Counter:
    """Monotonic counter. Optionally fn-backed (``fn`` returns the
    current value at scrape time — for pre-existing monotonic sources
    like ``PrefixTrie.evictions`` that should not be double-counted)."""

    __slots__ = ("labels", "value", "fn")

    def __init__(self, labels=(), fn: Optional[Callable[[], float]] = None):
        self.labels = labels
        self.value = 0
        self.fn = fn

    def inc(self, n=1):
        self.value += n

    def get(self):
        return self.fn() if self.fn is not None else self.value


class Gauge:
    """Point-in-time value; ``set`` for pushed values, ``fn`` for
    scrape-time sampling (pool utilization, queue depth — zero cost on
    the tick thread)."""

    __slots__ = ("labels", "value", "fn")

    def __init__(self, labels=(), fn: Optional[Callable[[], float]] = None):
        self.labels = labels
        self.value = 0.0
        self.fn = fn

    def set(self, v):
        self.value = v

    def get(self):
        return self.fn() if self.fn is not None else self.value


class Histogram:
    """Fixed-bucket histogram: ``counts[i]`` holds observations with
    ``v <= edges[i]`` (exclusive of lower edges), ``counts[-1]`` the
    +Inf overflow. Per-bucket (non-cumulative) storage keeps ``observe``
    one bisect + three adds; ``render`` cumulates."""

    __slots__ = ("labels", "edges", "counts", "sum", "count")

    def __init__(self, labels=(), edges: Sequence[float] = DURATION_BUCKETS):
        if list(edges) != sorted(edges) or len(set(edges)) != len(edges):
            raise ValueError(f"edges must be strictly increasing: {edges}")
        self.labels = labels
        self.edges = tuple(float(e) for e in edges)
        self.counts = [0] * (len(self.edges) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float):
        self.counts[bisect.bisect_left(self.edges, v)] += 1
        self.sum += v
        self.count += 1

    def quantile(self, q: float) -> Optional[float]:
        """Bucket-interpolated quantile (the ``histogram_quantile``
        estimate): linear within the containing bucket, lower bound 0
        for the first bucket, the last finite edge for +Inf. None when
        empty. Accurate to one bucket width — the numpy-reference test
        bounds it by the edge growth factor."""
        if self.count == 0:
            return None
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= target and c > 0:
                if i == len(self.edges):
                    return self.edges[-1]
                lo = self.edges[i - 1] if i > 0 else 0.0
                frac = (target - (cum - c)) / c
                return lo + frac * (self.edges[i] - lo)
        return self.edges[-1]  # pragma: no cover - cum==count>=target


_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """One metric name: its TYPE/HELP metadata plus one child per label
    value combination (a single unlabeled child when ``labels=()``)."""

    def __init__(self, name: str, help_: str, type_: str,
                 label_names: Tuple[str, ...], **child_kw):
        self.name = name
        self.help = help_
        self.type = type_
        self.label_names = label_names
        self._child_kw = child_kw
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()
        if not label_names:
            self._children[()] = _TYPES[type_](labels=(), **child_kw)

    def labels(self, **kv):
        """The child for one label-value combination, created on first
        use (under the family lock — the only cross-thread mutation)."""
        if set(kv) != set(self.label_names):
            raise ValueError(
                f"{self.name}: labels {sorted(kv)} != declared "
                f"{sorted(self.label_names)}")
        key = tuple(str(kv[k]) for k in self.label_names)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = _TYPES[self.type](
                        labels=tuple(zip(self.label_names, key)),
                        **self._child_kw)
                    self._children[key] = child
        return child

    # unlabeled families proxy the single child so call sites read
    # ``registry.counter(...).inc()`` without a labels() hop
    def _solo(self):
        if self.label_names:
            raise ValueError(f"{self.name} has labels {self.label_names}: "
                             f"use .labels(...)")
        return self._children[()]

    def inc(self, n=1):
        self._solo().inc(n)

    def set(self, v):
        self._solo().set(v)

    def observe(self, v):
        self._solo().observe(v)

    def get(self):
        return self._solo().get()

    def quantile(self, q):
        return self._solo().quantile(q)

    @property
    def children(self):
        with self._lock:
            return dict(self._children)


class MetricsRegistry:
    """Name -> family map with Prometheus text rendering.

    Registration is idempotent: re-registering an identical
    (name, type, labels) returns the existing family (a second
    front-end attaching to the same engine must not crash the server),
    while a conflicting re-registration raises — two meanings for one
    name is exactly the bug a registry exists to prevent.
    """

    def __init__(self):
        self._families: Dict[str, _Family] = {}
        self._lock = threading.Lock()

    def _register(self, name, help_, type_, labels, **child_kw) -> _Family:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        labels = tuple(labels)
        for ln in labels:
            if not _LABEL_RE.match(ln) or ln.startswith("__"):
                raise ValueError(f"invalid label name {ln!r} on {name}")
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.type != type_ or fam.label_names != labels:
                    raise ValueError(
                        f"metric {name} already registered as {fam.type}"
                        f"{fam.label_names}, not {type_}{labels}")
                # refresh fn bindings on re-registration: a new server
                # attaching to the engine re-points scrape callbacks at
                # its own live objects instead of a dead predecessor's
                fn = child_kw.get("fn")
                if fn is not None and not labels:
                    fam._children[()].fn = fn
                return fam
            fam = _Family(name, help_, type_, labels, **child_kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help_: str = "", labels=(),
                fn: Optional[Callable[[], float]] = None) -> _Family:
        kw = {"fn": fn} if fn is not None else {}
        return self._register(name, help_, "counter", labels, **kw)

    def gauge(self, name: str, help_: str = "", labels=(),
              fn: Optional[Callable[[], float]] = None) -> _Family:
        kw = {"fn": fn} if fn is not None else {}
        return self._register(name, help_, "gauge", labels, **kw)

    def histogram(self, name: str, help_: str = "", labels=(),
                  edges: Sequence[float] = DURATION_BUCKETS) -> _Family:
        return self._register(name, help_, "histogram", labels, edges=edges)

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def value_of(self, name: str, **labels):
        """Scrape one child's current value (None if absent) — the
        periodic stats line reads the registry through this."""
        fam = self.get(name)
        if fam is None:
            return None
        key = tuple(str(labels[k]) for k in fam.label_names
                    if k in labels)
        if len(key) != len(fam.label_names):
            return None
        child = fam.children.get(key)
        if child is None:
            return None
        return child.count if fam.type == "histogram" else child.get()

    def render(self) -> str:
        """Prometheus text exposition (format version 0.0.4): HELP/TYPE
        per family, cumulative ``le`` buckets + ``_sum``/``_count`` per
        histogram child."""
        out: List[str] = []
        with self._lock:
            families = sorted(self._families.items())
        for name, fam in families:
            if fam.help:
                out.append(f"# HELP {name} {fam.help}")
            out.append(f"# TYPE {name} {fam.type}")
            for child in fam.children.values():
                base = dict(child.labels)
                if fam.type == "histogram":
                    cum = 0
                    for edge, c in zip(child.edges, child.counts):
                        cum += c
                        lab = _label_str(tuple(base.items())
                                         + (("le", _fmt(edge)),))
                        out.append(f"{name}_bucket{lab} {cum}")
                    cum += child.counts[-1]
                    lab = _label_str(tuple(base.items()) + (("le", "+Inf"),))
                    out.append(f"{name}_bucket{lab} {cum}")
                    ls = _label_str(tuple(base.items()))
                    out.append(f"{name}_sum{ls} {_fmt(child.sum)}")
                    out.append(f"{name}_count{ls} {cum}")
                else:
                    out.append(f"{name}{_label_str(child.labels)} "
                               f"{_fmt(child.get())}")
        return "\n".join(out) + "\n"


# ---------------------------------------------------------------------
# request lifecycle spans

QUEUE, ENCODE, PREFILL, DECODE, PARKED = (
    "queue", "encode", "prefill", "decode", "parked")
SPAN_PHASES = (QUEUE, ENCODE, PREFILL, DECODE, PARKED)


class RequestSpan:
    """One request's wall-clock lifecycle, every moment attributed to
    exactly one phase. Transitions close the open interval into
    ``phases`` and open the next, so intervals are disjoint and cover
    [submit_t, finish_t] — ``sum(phases.values())`` equals the wall
    time up to float rounding, which is the ``<=`` invariant the span
    test pins across preemption and encdec ENCODE phases."""

    __slots__ = ("rid", "submit_t", "admit_t", "first_token_t", "finish_t",
                 "finish_reason", "phases", "phase", "_t0", "last_token_t")

    def __init__(self, rid: int, now: float):
        self.rid = rid
        self.submit_t = now
        self.admit_t: Optional[float] = None
        self.first_token_t: Optional[float] = None
        self.finish_t: Optional[float] = None
        self.finish_reason: Optional[str] = None
        self.phases: Dict[str, float] = {}
        self.phase = QUEUE
        self._t0 = now
        self.last_token_t: Optional[float] = None

    def to_phase(self, phase: str, now: float):
        dt = now - self._t0
        if dt > 0:
            self.phases[self.phase] = self.phases.get(self.phase, 0.0) + dt
        self.phase = phase
        self._t0 = now

    def mark_admit(self, now: float, phase: str):
        self.admit_t = now
        self.to_phase(phase, now)

    def token(self, now: float) -> bool:
        """Record a token emission; True when it was the first."""
        first = self.first_token_t is None
        if first:
            self.first_token_t = now
        self.last_token_t = now
        return first

    def finish(self, now: float, reason: str):
        self.to_phase("done", now)
        self.finish_t = now
        self.finish_reason = reason

    @property
    def wall(self) -> Optional[float]:
        return (self.finish_t - self.submit_t
                if self.finish_t is not None else None)


# ---------------------------------------------------------------------
# structured trace events

class TraceRing:
    """Bounded ring of structured trace events. ``append`` is one deque
    append (thread-safe under the GIL); overflow silently drops the
    OLDEST events and counts them, so a long-running server with a
    forgotten ring never grows without bound."""

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1: {capacity}")
        self.capacity = capacity
        self._buf: collections.deque = collections.deque(maxlen=capacity)
        self._seen = 0

    def emit(self, event: str, **fields):
        self._seen += 1
        rec = {"ts": round(time.time(), 6), "event": event}
        rec.update(fields)
        self._buf.append(rec)

    def __len__(self):
        return len(self._buf)

    @property
    def dropped(self) -> int:
        return max(0, self._seen - self.capacity)

    def drain(self) -> List[dict]:
        out = list(self._buf)
        self._buf.clear()
        return out

    def write_jsonl(self, path) -> int:
        """Flush the ring to a JSON-lines file (the ``--trace-log``
        sink); returns how many events were written."""
        import json

        events = self.drain()
        with open(path, "a") as f:
            for rec in events:
                f.write(json.dumps(rec) + "\n")
        return len(events)


# ---------------------------------------------------------------------
# the serving metric families

# tick phases: admission bookkeeping, the preempt pass, the one-per-tick
# encoder call, and the prefill / decode ticks split device vs host: "device"
# runs from the tick's launch (or graph replay) to the host copy of its
# sampled tokens, "host" is the token / retirement loop after it.
TICK_PHASES = ("admission", "preempt", "encode",
               "prefill_device", "prefill_host",
               "decode_device", "decode_host")


class EngineTelemetry:
    """The standard serving metric families over one registry, plus the
    span bookkeeping and the optional trace ring. Engine-side only —
    a front-end registers its own families into the same registry, so
    one ``render()`` covers the whole process."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 trace_events: int = 0):
        self.registry = r = registry or MetricsRegistry()
        self.ring = TraceRing(trace_events) if trace_events else None

        self.submitted = r.counter(
            "serve_requests_submitted_total", "Requests accepted by submit()")
        self.finished = r.counter(
            "serve_requests_finished_total",
            "Requests finished, by finish reason", labels=("reason",))
        self.rejected = r.counter(
            "serve_requests_rejected_total",
            "Submits rejected by admission-queue backpressure")
        self.tokens = r.counter(
            "serve_tokens_total", "Output tokens emitted by the tick loop")
        self.prefill_tokens = r.counter(
            "serve_prefill_tokens_total",
            "Prompt tokens streamed through chunked prefill")
        self.prefix_lookups = r.counter(
            "serve_prefix_lookups_total",
            "Prefix-trie admission lookups, by result", labels=("result",))
        self.preempts = r.counter(
            "serve_preempts_total", "Slots parked by the preempt pass")
        self.resumes = r.counter(
            "serve_resumes_total", "Parked requests resumed into a slot")
        self.encode_ticks = r.counter(
            "serve_encode_ticks_total", "Encoder passes run by the ENCODE phase")
        self.retraces = r.counter(
            "serve_retraces_total",
            "Tick bodies run eagerly after warmup() instead of replaying "
            "their captured graph (steady state must stay 0)")

        self.ttft = r.histogram(
            "serve_request_ttft_seconds",
            "Submit to first emitted token, queue wait included")
        self.itl = r.histogram(
            "serve_request_itl_seconds",
            "Gap between consecutive emitted tokens of one request")
        self.e2e = r.histogram(
            "serve_request_e2e_seconds", "Submit to finish, whole lifecycle")
        self.queue_wait = r.histogram(
            "serve_request_queue_wait_seconds", "Submit to slot admission")
        self.tick = r.histogram(
            "serve_tick_seconds", "One engine tick, all phases")
        tick_phase = r.histogram(
            "serve_tick_phase_seconds", "One engine tick, by phase",
            labels=("phase",))
        # children pre-resolved so the tick path never takes the family
        # lock or hashes label kwargs
        self.tick_phase = {p: tick_phase.labels(phase=p)
                           for p in TICK_PHASES}

    def bind_engine(self, engine):
        """Register the scrape-time gauges that read live engine state
        (zero tick-thread cost: sampled only when the registry renders)."""
        r = self.registry
        r.gauge("serve_queue_depth", "Requests waiting for admission",
                fn=lambda: engine._queue.qsize())
        r.gauge("serve_live_slots", "Slots with a live request",
                fn=lambda: len(engine._live))
        r.gauge("serve_free_slots", "Unoccupied slots",
                fn=lambda: len(engine._free))
        r.gauge("serve_parked_requests", "Preempted requests awaiting resume",
                fn=lambda: len(engine._parked))
        pools = r.gauge("serve_pool_pages", "KV pool capacity in pages",
                        labels=("family",))
        used = r.gauge("serve_pool_pages_used", "KV pool pages referenced",
                       labels=("family",))
        util = r.gauge("serve_pool_utilization",
                       "KV pool pages referenced / capacity",
                       labels=("family",))
        for pool in (engine.pool, engine.xpool):
            if pool is None:
                continue
            pools.labels(family=pool.family).fn = (
                lambda p=pool: p.n_pages)
            used.labels(family=pool.family).fn = (
                lambda p=pool: p.used_pages)
            util.labels(family=pool.family).fn = (
                lambda p=pool: p.utilization)
        if engine.trie is not None:
            r.gauge("serve_trie_nodes", "Prefix-trie nodes pinned",
                    fn=lambda: len(engine.trie))
            r.counter("serve_trie_evictions_total",
                      "Prefix-trie LRU leaf evictions",
                      fn=lambda: engine.trie.evictions)
            # the trie owns its lookup bookkeeping (PrefixTrie.match);
            # fn-backing the children avoids a second engine-side count
            self.prefix_lookups.labels(result="hit").fn = (
                lambda: engine.trie.hits)
            self.prefix_lookups.labels(result="miss").fn = (
                lambda: engine.trie.misses)
        if engine.enc_cache is not None:
            r.gauge("serve_enc_cache_entries",
                    "Cached encoder outputs (digest-keyed)",
                    fn=lambda: len(engine.enc_cache))
        return self

    # ---- scrape-side summaries ---------------------------------------
    def latency_summary(self) -> Dict[str, Dict[str, Optional[float]]]:
        """Histogram quantiles in ms for ``BatchedEngine.stats()``:
        {"ttft_ms": {"p50":…, "p99":…, "count":…}, …}. Quantiles are
        bucket-interpolated — accurate to one log-bucket width."""
        def q(h):
            return {
                "p50": _ms(h.quantile(0.50)),
                "p99": _ms(h.quantile(0.99)),
                "count": h.count if hasattr(h, "count") else h._solo().count,
            }

        return {
            "ttft_ms": q(self.ttft._solo()),
            "itl_ms": q(self.itl._solo()),
            "e2e_ms": q(self.e2e._solo()),
            "queue_wait_ms": q(self.queue_wait._solo()),
            "tick_ms": q(self.tick._solo()),
        }


def _ms(v: Optional[float]) -> Optional[float]:
    return None if v is None else round(1e3 * v, 3)
