"""The port's telemetry walls (counterparts of tests/test_telemetry.py up to
its HTTP tests), at ``.reduced()`` size.

Telemetry is observation only: the engine emits byte-identical tokens with
it on (metrics, spans, the trace ring) or off. The numbers are held to
references: histogram counts and quantiles to numpy, the Prometheus text to
a format lint, span phases to the wall clock (disjoint phases that cover a
request's life, across preemption and an encoder-decoder's ENCODE), and the
eager-tick detector to a warmed engine (silent) and one whose decode tick
fell off its graph (fires, warns once). Also the serve CLI's
``--shared-prefix``, ``--priorities``, ``--preempt`` and ``--trace-log``.
"""
import functools
import json
import warnings

import numpy as np
import pytest
import torch

from repro_torch.configs import build_model, get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.nn import module as mod
from repro_torch.nn.context import SERVE, ModelContext
from repro_torch.serve.engine import BatchedEngine, ServeConfig
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.telemetry import (
    DECODE,
    DURATION_BUCKETS,
    ENCODE,
    PARKED,
    PREFILL,
    QUEUE,
    Histogram,
    MetricsRegistry,
    RequestSpan,
    TraceRing,
    log_buckets,
)

torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def build_serve(arch="granite-8b"):
    cfg = get_config(arch).reduced()
    sm = build_model(cfg, ModelContext(policy=cfg.tbn, mode=SERVE,
                                       compute_dtype=torch.float32, device="cpu"))
    return cfg, sm, mod.init_params(sm.specs(), 0, "cpu")


def make_engine(arch="granite-8b", **cfg_kw):
    _, sm, sp = build_serve(arch)
    kw = dict(n_slots=2, max_len=64, chunk_tokens=8, page_tokens=8)
    kw.update(cfg_kw)
    return BatchedEngine(sm, sp, ServeConfig(**kw))


def drain(eng, reqs):
    i = 0
    while eng.has_work:
        assert i < 2000, "engine wedged"
        eng.step()
        i += 1
    return [list(r.output) for r in reqs]


class TestHistogram:
    def test_counts_and_sum_match_numpy(self):
        rng = np.random.default_rng(0)
        vals = rng.lognormal(mean=-6, sigma=2, size=2000)
        h = Histogram(edges=DURATION_BUCKETS)
        for v in vals:
            h.observe(float(v))
        assert h.count == len(vals)
        assert h.sum == pytest.approx(float(np.sum(vals)))
        # bucket i holds v <= edges[i]; np.histogram is right-exclusive, and
        # the lognormal draw never lands on an edge
        ref, _ = np.histogram(vals, bins=np.array((0.0,) + DURATION_BUCKETS
                                                  + (np.inf,)))
        assert h.counts == ref.tolist()

    @pytest.mark.parametrize("q", [0.1, 0.5, 0.9, 0.99])
    def test_quantile_within_one_bucket_of_numpy(self, q):
        rng = np.random.default_rng(1)
        vals = rng.lognormal(mean=-4, sigma=1.5, size=5000)
        h = Histogram(edges=DURATION_BUCKETS)
        for v in vals:
            h.observe(float(v))
        est, ref = h.quantile(q), float(np.quantile(vals, q))
        growth = 10 ** (1 / 6)
        assert ref / growth <= est <= ref * growth, (q, est, ref)

    def test_empty_and_overflow(self):
        h = Histogram(edges=(1.0, 10.0))
        assert h.quantile(0.5) is None
        h.observe(5000.0)
        assert h.counts == [0, 0, 1] and h.quantile(0.5) == 10.0

    def test_log_buckets_shape(self):
        edges = log_buckets(1e-3, 1.0, per_decade=3)
        assert edges[0] == 1e-3 and list(edges) == sorted(set(edges))
        assert len(edges) == 10
        with pytest.raises(ValueError):
            log_buckets(0, 1.0)


class TestRegistry:
    def test_counter_gauge_labels_and_values(self):
        r = MetricsRegistry()
        c = r.counter("t_total", "help", labels=("kind",))
        c.labels(kind="a").inc()
        c.labels(kind="a").inc(2)
        c.labels(kind="b").inc()
        g = r.gauge("t_gauge", fn=lambda: 42)
        assert r.value_of("t_total", kind="a") == 3
        assert r.value_of("t_total", kind="b") == 1
        assert r.value_of("t_total", kind="zzz") is None
        assert g.get() == 42

    def test_reregistration_idempotent_and_conflict(self):
        r = MetricsRegistry()
        a = r.counter("x_total", labels=("k",))
        assert r.counter("x_total", labels=("k",)) is a
        for bad in (lambda: r.gauge("x_total"),
                    lambda: r.counter("x_total", labels=("other",)),
                    lambda: r.counter("bad name")):
            with pytest.raises(ValueError):
                bad()

    def test_exposition_format_lint(self):
        r = MetricsRegistry()
        r.counter("lint_total", "a counter").inc(3)
        r.gauge("lint_gauge", "a gauge").set(1.5)
        h = r.histogram("lint_seconds", "a histogram", labels=("phase",))
        for i in range(50):
            h.labels(phase="p").observe(10 ** ((i % 9) - 5))
        text = r.render()
        assert text.endswith("\n")
        types, samples = {}, {}
        for line in text.splitlines():
            if line.startswith("# TYPE "):
                _, _, name, t = line.split()
                types[name] = t
            elif not line.startswith("#"):
                key, _, val = line.rpartition(" ")
                samples[key] = float(val)
        assert types == {"lint_total": "counter", "lint_gauge": "gauge",
                         "lint_seconds": "histogram"}
        assert samples["lint_total"] == 3 and samples["lint_gauge"] == 1.5
        buckets = [(k, v) for k, v in samples.items()
                   if k.startswith("lint_seconds_bucket")]
        cums = [v for _, v in buckets]
        assert cums == sorted(cums)
        assert 'le="+Inf"' in buckets[-1][0]
        assert buckets[-1][1] == samples['lint_seconds_count{phase="p"}'] == 50

    def test_label_escaping(self):
        r = MetricsRegistry()
        r.counter("esc_total", labels=("k",)).labels(k='a"b\nc\\d').inc()
        line = [ln for ln in r.render().splitlines()
                if ln.startswith("esc_total{")][0]
        assert line == 'esc_total{k="a\\"b\\nc\\\\d"} 1'


class TestSpanAndRing:
    def test_phases_disjoint_and_cover_wall(self):
        s = RequestSpan(rid=1, now=100.0)
        s.mark_admit(101.0, PREFILL)
        s.to_phase(DECODE, 101.5)
        s.to_phase(PARKED, 102.0)
        s.to_phase(DECODE, 103.0)
        s.finish(103.25, "length")
        assert s.phases == {QUEUE: 1.0, PREFILL: 0.5, DECODE: 0.75, PARKED: 1.0}
        assert sum(s.phases.values()) == pytest.approx(s.wall) == 3.25

    def test_token_marks_first(self):
        s = RequestSpan(rid=0, now=0.0)
        assert s.token(1.0) is True and s.token(2.0) is False
        assert (s.first_token_t, s.last_token_t) == (1.0, 2.0)

    def test_ring_drops_oldest_and_counts(self):
        ring = TraceRing(capacity=3)
        for i in range(5):
            ring.emit("e", i=i)
        assert len(ring) == 3 and ring.dropped == 2
        assert [r["i"] for r in ring.drain()] == [2, 3, 4] and len(ring) == 0

    def test_ring_jsonl_sink(self, tmp_path):
        ring = TraceRing(capacity=8)
        ring.emit("submit", rid=1)
        ring.emit("finish", rid=1, reason="length")
        path = tmp_path / "trace.jsonl"
        assert ring.write_jsonl(path) == 2
        recs = [json.loads(ln) for ln in path.read_text().splitlines()]
        assert [r["event"] for r in recs] == ["submit", "finish"]
        assert all("ts" in r for r in recs)


class TestEngineTelemetry:
    def test_token_parity_on_vs_off(self):
        """Byte-identical seeded stochastic tokens with telemetry (metrics,
        spans, the ring) on and off, the prefix cache and preemption
        exercised."""
        rng = np.random.default_rng(2)
        prompts = [rng.integers(0, 64, size=n).astype(np.int32)
                   for n in (5, 11, 7, 9, 11)]
        prompts[4][:8] = prompts[1][:8]
        params = [SamplingParams(max_tokens=6, temperature=0.9, top_k=8,
                                 seed=50 + i, priority=("interactive" if i == 3
                                                        else "batch"))
                  for i in range(len(prompts))]
        outs = {}
        for on in (False, True):
            eng = make_engine(telemetry=on, prefix_cache=True, priorities=True,
                              preempt=True, trace_events=64 if on else 0)
            jobs = list(zip(prompts, params))
            # the last prompt shares its first page with the second, which
            # has retired (and published) by the time it is submitted
            outs[on] = (drain(eng, [eng.submit(p, sp) for p, sp in jobs[:4]])
                        + drain(eng, [eng.submit(p, sp) for p, sp in jobs[4:]]))
            assert eng.stats()["prefix_hits"] == 1
        assert outs[True] == outs[False]

    def test_lifecycle_metrics_and_spans(self):
        eng = make_engine(trace_events=64)
        reqs = [eng.submit([1, 2, 3, 4, 5], SamplingParams(max_tokens=4))
                for _ in range(3)]
        drain(eng, reqs)
        tel = eng.tel
        assert tel.submitted.get() == 3
        assert tel.finished.labels(reason="length").get() == 3
        assert tel.tokens.get() == 12
        assert tel.ttft._solo().count == 3 and tel.itl._solo().count == 9
        assert tel.tick._solo().count > 0
        observed = {p for p, h in tel.tick_phase.items() if h.count}
        assert {"admission", "decode_device", "decode_host",
                "prefill_device", "prefill_host"} <= observed
        assert "encode" not in observed
        for r in reqs:
            s = r.span
            assert s.finish_reason == "length"
            assert set(s.phases) <= {QUEUE, PREFILL, DECODE}
            assert sum(s.phases.values()) <= s.wall + 1e-6
            assert sum(s.phases.values()) == pytest.approx(s.wall, rel=1e-3)
        events = [e["event"] for e in tel.ring.drain()]
        assert events.count("submit") == events.count("finish") == 3
        assert events.count("admit") == 3
        st = eng.stats()
        assert st["latency"]["ttft_ms"]["count"] == 3 and st["retraces"] == 0

    def test_span_phases_across_preemption(self):
        eng = make_engine(n_slots=1, priorities=True, preempt=True, max_queued=8,
                          trace_events=32)
        lo = eng.submit([1, 2, 3], SamplingParams(max_tokens=8, priority="batch"))
        for _ in range(3):
            eng.step()
        hi = eng.submit([4, 5], SamplingParams(max_tokens=2, priority="interactive"))
        drain(eng, [lo, hi])
        assert eng.tel.preempts.get() >= 1 and eng.tel.resumes.get() >= 1
        s = lo.span
        assert s.phases.get(PARKED, 0.0) > 0.0
        assert sum(s.phases.values()) == pytest.approx(s.wall, rel=1e-3)
        events = [e["event"] for e in eng.tel.ring.drain()]
        assert "preempt" in events and "resume" in events
        assert lo.output and hi.output

    def test_span_encode_phase_encdec(self):
        cfg, sm, sp = build_serve("seamless-m4t-large-v2")
        eng = BatchedEngine(sm, sp, ServeConfig(
            n_slots=2, max_len=64, chunk_tokens=8, page_tokens=8, enc_tokens=16))
        frames = np.random.default_rng(3).standard_normal(
            (9, cfg.d_model)).astype(np.float32)
        req = eng.submit([3, 1, 4], SamplingParams(max_tokens=3), frames=frames)
        drain(eng, [req])
        assert eng.tel.encode_ticks.get() == 1
        assert eng.tel.tick_phase["encode"].count == 1
        s = req.span
        assert s.phases.get(ENCODE, 0.0) > 0.0
        assert sum(s.phases.values()) == pytest.approx(s.wall, rel=1e-3)

    def test_pool_and_queue_gauges(self):
        eng = make_engine(prefix_cache=True)
        r = eng.tel.registry
        assert r.value_of("serve_pool_pages", family="self_attn") == eng.pool.n_pages
        assert r.value_of("serve_pool_utilization", family="self_attn") == 0.0
        reqs = [eng.submit([1, 2, 3, 4], SamplingParams(max_tokens=2))
                for _ in range(2)]
        assert r.value_of("serve_queue_depth") == 2
        eng.step()
        assert r.value_of("serve_queue_depth") == 0
        assert r.value_of("serve_live_slots") == 2
        assert r.value_of("serve_pool_utilization", family="self_attn") > 0.0
        drain(eng, reqs)
        assert (r.value_of("serve_prefix_lookups_total", result="hit")
                + r.value_of("serve_prefix_lookups_total", result="miss")) == 2
        assert "serve_trie_nodes" in r.render()

    def test_telemetry_off_is_off(self):
        eng = make_engine(telemetry=False)
        assert eng.tel is None
        req = eng.submit([1, 2, 3], SamplingParams(max_tokens=2))
        drain(eng, [req])
        assert req.span is None and "latency" not in eng.stats()

    def test_trace_events_requires_telemetry(self):
        with pytest.raises(ValueError, match="requires telemetry"):
            make_engine(telemetry=False, trace_events=16)


class TestEagerTickDetector:
    def test_silent_after_warmup_and_fires_on_an_eager_tick(self):
        """A warmed engine (on this host each entry point's stand-in for a
        replay is its eager body, which the detector discounts) stays
        silent; once the decode tick falls off its graph, the tick body
        runs eagerly, the count moves and the engine warns once."""
        eng = make_engine(trace_events=16)
        eng.warmup()
        reqs = [eng.submit([1, 2, 3], SamplingParams(max_tokens=3))
                for _ in range(2)]
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            drain(eng, reqs)
        assert eng.tel.retraces.get() == 0
        eng._graphs.pop("decode_tick")
        req = eng.submit([4, 5], SamplingParams(max_tokens=2))
        with pytest.warns(RuntimeWarning, match="eagerly"):
            drain(eng, [req])
        n = eng.tel.retraces.get()
        assert n >= 1 and eng.stats()["retraces"] == n
        assert any(e["event"] == "retrace" for e in eng.tel.ring.drain())
        eng._graphs.pop("extend_tick")
        req = eng.submit([6, 7, 8, 9], SamplingParams(max_tokens=2))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            drain(eng, [req])
        assert eng.tel.retraces.get() > n

    def test_cold_engine_is_not_armed(self):
        eng = make_engine()
        drain(eng, [eng.submit([1, 2, 3], SamplingParams(max_tokens=3))])
        assert eng.tel.retraces.get() == 0


def test_serve_cli_features_and_trace_log(tmp_path, capsys):
    log = tmp_path / "trace.jsonl"
    reqs = serve_cli.main(["--reduced", "--device", "cpu", "--requests", "8",
                           "--max-tokens", "3", "--max-len", "48", "--slots", "2",
                           "--shared-prefix", "16", "--priorities", "--preempt",
                           "--trace-log", str(log)])
    out = capsys.readouterr().out
    assert all(r.done and len(r.output) == 3 for r in reqs)
    assert all(len(r.prompt) >= 19 for r in reqs)
    hits = sum(r.prefix_hit_tokens > 0 for r in reqs)
    assert hits >= 1 and f"({hits}/8 admissions)" in out
    assert "scheduler (priority+preempt)" in out
    assert sum(r.priority == "interactive" for r in reqs) == 2
    events = [json.loads(ln)["event"] for ln in log.read_text().splitlines()]
    assert events.count("submit") == events.count("admit") == 8
    assert events.count("finish") == 8
    assert f"trace log: {len(events)} events -> {log}" in out
    # the same run without the cache and the scheduler gives the same tokens
    plain = serve_cli.main(["--reduced", "--device", "cpu", "--requests", "8",
                            "--max-tokens", "3", "--max-len", "48", "--slots", "2",
                            "--shared-prefix", "16", "--no-prefix-cache",
                            "--no-telemetry"])
    assert [r.output for r in plain] == [r.output for r in reqs]
    assert "prefix cache: disabled" in capsys.readouterr().out
