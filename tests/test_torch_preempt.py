"""The port's preemption walls (counterparts of tests/test_preempt.py), plus
the ``ServeConfig`` validation and scheduler counters of tests/test_serve.py,
at ``.reduced()`` size in f32.

Forced preempt-and-resume (every live slot parked every few ticks) and the
scheduler's own priority preemption give the JAX engine's greedy tokens,
finish reasons, token steps, ticks and preempt / resume counts on the same
params and ``ServeConfig``, on granite-8b (also xnor, int8 and int8 K/V),
recurrentgemma-2b and mamba2-370m; within the port the tokens equal a run
that is never preempted, greedy and seeded stochastic (parking keeps the
pages, snapshots the per-slot rows at the preemption position and carries
the emitted count, which is the sampler's token index). Then the scheduler
policy: prefix-aware queue jumping through the non-pinning probe, the
aging floor, the immunity cap, abort of a parked request, FIFO without
``priorities``, unknown classes; abort / ``abort_all`` / hooks.
"""
import numpy as np
import pytest

from repro_torch.serve.engine import AdmissionQueueFull, ServeConfig
from repro_torch.serve.sampling import SamplingParams
from test_torch_prefix_cache import FAMILY_ARCHS, JAX, PORT, engine

# short prompts decode-dominate (mid-decode preemption); the long prompt
# spends >= 4 ticks in prefill at chunk_tokens=8 (mid-prefill preemption)
SHORT_PROMPTS = [[3, 9, 4, 11, 7, 2, 5], [8, 6, 1, 12, 0], [5, 5, 2, 8]]
LONG_PROMPT = list(range(36))


def run(pkg, arch, prompts, *, preempt_every=0, max_tokens=6, max_ticks=800,
        kv_dtype=None, path="float", params=None, **cfg_over):
    """Submit ``prompts`` in order and drain, parking every live slot every
    ``preempt_every`` ticks (0: never). -> (engine, summary, parked phases)."""
    eng = engine(pkg, arch, kv_dtype, path, **cfg_over)
    params = params or {}
    reqs = [eng.submit(np.asarray(p, np.int32),
                       pkg.Params(max_tokens=max_tokens, **params))
            for p in prompts]
    phases, i = set(), 0
    while eng.has_work:
        assert i < max_ticks, "the schedule wedged the engine"
        if preempt_every and i % preempt_every == preempt_every - 1:
            for slot in list(eng._live):
                phases.add(eng._phase[slot])
                assert eng.preempt_slot(slot)
        eng.step()
        i += 1
    st = eng.stats()
    return eng, ([r.output for r in reqs], [r.finish_reason for r in reqs],
                 [r.token_steps for r in reqs], i,
                 st["preempts"], st["resumes"]), phases


class TestPreemptParityWall:
    @pytest.mark.parametrize("arch,path,kv", [(a, "float", None) for a in FAMILY_ARCHS]
                             + [("granite-8b", "xnor", None),
                                ("granite-8b", "int8", None),
                                ("granite-8b", "float", "int8")])
    def test_forced_mid_decode_equals_reference(self, arch, path, kv):
        """Every 3rd tick parks every live slot: the port gives the JAX
        engine's tokens, steps, ticks and counts, and the tokens of a run
        that is never preempted."""
        eng, got, phases = run(PORT, arch, SHORT_PROMPTS, preempt_every=3,
                               path=path, kv_dtype=kv)
        assert "decode" in phases
        assert got == run(JAX, arch, SHORT_PROMPTS, preempt_every=3, path=path,
                          kv_dtype=kv)[1]
        _, base, _ = run(PORT, arch, SHORT_PROMPTS, path=path, kv_dtype=kv)
        assert got[:2] == base[:2]
        st = eng.stats()
        assert st["preempts"] > 0 and st["resumes"] == st["preempts"]
        assert st["parked"] == 0
        assert st["preempt_free_ticks"] < st["work_ticks"]
        if eng.pool is not None:
            eng.pool.check()
            assert eng.pool.used_pages == 0

    @pytest.mark.parametrize("arch", FAMILY_ARCHS)
    def test_seeded_stochastic_preempted_equals_unpreempted(self, arch):
        """The resumed slot draws from its stream at the emitted count: the
        stochastic stream continues, not just the argmax."""
        kw = dict(max_tokens=7, seed=3, params=dict(temperature=1.0, top_k=5))
        _, base, _ = run(PORT, arch, SHORT_PROMPTS, **kw)
        _, got, _ = run(PORT, arch, SHORT_PROMPTS, preempt_every=3, **kw)
        assert got[0] == base[0]

    @pytest.mark.parametrize("arch", FAMILY_ARCHS)
    def test_preempt_while_prefilling_equals_reference(self, arch):
        prompts = [LONG_PROMPT, SHORT_PROMPTS[0]]
        _, got, phases = run(PORT, arch, prompts, preempt_every=2, max_tokens=4)
        assert "prefill" in phases
        _, base, _ = run(PORT, arch, prompts, max_tokens=4)
        assert got[:2] == base[:2]
        assert got == run(JAX, arch, prompts, preempt_every=2, max_tokens=4)[1]

    def test_preempt_every_tick_still_drains(self):
        _, base, _ = run(PORT, "granite-8b", SHORT_PROMPTS[:2])
        _, got, _ = run(PORT, "granite-8b", SHORT_PROMPTS[:2], preempt_every=1)
        assert got[0] == base[0]

    def test_natural_priority_preempt_and_overtake_equals_reference(self):
        """A late interactive request on a full 1-slot engine preempts the
        decoding batch request, finishes first, and no token of either
        stream changes."""
        def scenario(pkg, prio):
            eng = engine(pkg, "granite-8b", n_slots=1, priorities=prio,
                         preempt=prio)
            cls = (lambda c: c) if prio else (lambda c: None)
            rb = eng.submit(np.asarray(SHORT_PROMPTS[0], np.int32),
                            pkg.Params(max_tokens=12, priority=cls("batch")))
            rq = eng.submit(np.asarray([8, 6, 1, 12, 0, 9, 2], np.int32),
                            pkg.Params(max_tokens=4, priority=cls("batch")))
            for _ in range(4):
                eng.step()
            ri = eng.submit(np.asarray(SHORT_PROMPTS[2], np.int32),
                            pkg.Params(max_tokens=3, priority=cls("interactive")))
            eng.run_until_drained()
            st = eng.stats()
            return eng, (rb, rq, ri), (
                [r.output for r in (rb, rq, ri)], [r.token_steps for r in (rb, rq, ri)],
                st["preempts"], st["resumes"], st["preempted_tokens"],
                st["class_ttft_ticks"], st["class_counts"])

        eng, (rb, rq, ri), got = scenario(PORT, True)
        assert ri.token_steps[0] < rb.token_steps[-1], "no overtake"
        assert ri.token_steps[0] < rq.token_steps[0], "no queue jump"
        assert rb.preempt_count >= 1
        assert got[2] >= 1 and got[3] >= 1 and got[4] > 0
        assert got[5]["interactive"] < got[5]["batch"]
        assert got[6] == {"batch": 2, "interactive": 1}
        assert got == scenario(JAX, True)[2]
        assert got[0] == scenario(PORT, False)[2][0]

    @pytest.mark.parametrize("arch", FAMILY_ARCHS)
    def test_chaos_leaves_no_pool_state(self, arch):
        eng, _, _ = run(PORT, arch, SHORT_PROMPTS, preempt_every=2)
        assert not eng._parked
        if eng.pool is not None:
            eng.pool.check()
            assert eng.pool.used_pages == 0


class TestSchedulerPolicy:
    def test_prefix_aware_admission_jump(self):
        """A queued request whose prompt is mostly cached overtakes an older
        uncached one of the same class, in both packages alike."""
        def scenario(pkg):
            eng = engine(pkg, "granite-8b", n_slots=1, prefix_cache=True,
                         priorities=True)
            warm = np.arange(24, dtype=np.int32)
            eng.submit(warm, pkg.Params(max_tokens=2))
            eng.run_until_drained()
            eng.submit(np.asarray(SHORT_PROMPTS[1], np.int32), pkg.Params(max_tokens=2))
            eng.step()
            rng = np.random.default_rng(1)
            cold = eng.submit(rng.integers(100, 200, size=24).astype(np.int32),
                              pkg.Params(max_tokens=2))
            cached = eng.submit(warm, pkg.Params(max_tokens=2))
            eng.run_until_drained()
            return (cached.admit_step, cold.admit_step, cached.prefix_hit_tokens,
                    cached.output, cold.output)

        got = scenario(PORT)
        assert got[0] < got[1] and got[2] > 0
        assert got == scenario(JAX)

    def test_probe_does_not_pin(self):
        eng = engine(PORT, "granite-8b", prefix_cache=True)
        warm = np.arange(24, dtype=np.int32)
        eng.submit(warm, SamplingParams(max_tokens=2))
        eng.run_until_drained()
        trie = eng.trie
        before = {id(n): n.last_used for n in trie._nodes}
        depth = trie.probe(warm, require_snapshot=eng._stateful)
        assert depth > 0
        assert {id(n): n.last_used for n in trie._nodes} == before
        path = trie.match(warm, require_snapshot=eng._stateful, now=999)
        assert depth == len(path) * trie.pt
        assert any(n.last_used == 999 for n in trie._nodes)

    def test_starvation_floor(self):
        """After starvation_limit consecutive overtakes the oldest waiter
        goes next."""
        eng = engine(PORT, "granite-8b", n_slots=1, priorities=True,
                     starvation_limit=2)
        eng.submit(np.asarray(SHORT_PROMPTS[0], np.int32),
                   SamplingParams(max_tokens=2, priority="interactive"))
        eng.step()
        batch = eng.submit(np.asarray(SHORT_PROMPTS[1], np.int32),
                           SamplingParams(max_tokens=2, priority="batch"))
        flood = [eng.submit(np.asarray(SHORT_PROMPTS[2], np.int32),
                            SamplingParams(max_tokens=2, priority="interactive"))
                 for _ in range(5)]
        eng.run_until_drained()
        assert sum(r.admit_step < batch.admit_step for r in flood) == 2

    def test_preempt_immunity_cap(self):
        eng = engine(PORT, "granite-8b", n_slots=1, priorities=True, preempt=True,
                     max_preempts=1)
        rb = eng.submit(np.asarray(SHORT_PROMPTS[0], np.int32),
                        SamplingParams(max_tokens=16, priority="batch"))
        for _ in range(3):
            eng.step()
        eng.submit(np.asarray(SHORT_PROMPTS[2], np.int32),
                   SamplingParams(max_tokens=2, priority="interactive"))
        eng.step()
        assert rb.preempt_count == 1 and eng._parked
        while eng._parked:
            eng.step()
        ri2 = eng.submit(np.asarray(SHORT_PROMPTS[2], np.int32),
                         SamplingParams(max_tokens=2, priority="interactive"))
        eng.run_until_drained()
        assert rb.preempt_count == 1 and eng.stats()["preempts"] == 1
        assert ri2.done and ri2.finish_reason in ("length", "eos")

    def test_abort_parked_request_releases_everything(self):
        eng = engine(PORT, "granite-8b")
        finished = []
        eng.on_finish = finished.append
        ra = eng.submit(np.asarray(SHORT_PROMPTS[0], np.int32),
                        SamplingParams(max_tokens=10))
        rb = eng.submit(np.asarray(SHORT_PROMPTS[1], np.int32),
                        SamplingParams(max_tokens=4))
        for _ in range(3):
            eng.step()
        slot = next(s for s, r in eng._live.items() if r is ra)
        assert eng.preempt_slot(slot)
        held = eng.pool.used_pages
        assert held > 0
        assert eng.abort(ra) and not eng.abort(ra)
        assert ra.finish_reason == "aborted" and finished == [ra]
        assert not eng._parked and eng.pool.used_pages < held
        eng.run_until_drained()
        assert rb.done and rb.finish_reason != "aborted" and finished == [ra, rb]
        eng.pool.check()
        assert eng.pool.used_pages == 0

    @pytest.mark.parametrize("arch", ["granite-8b", "mamba2-370m"])
    def test_abort_live_parked_and_all_frees_everything(self, arch):
        """abort of a live and of a parked request, then abort_all mid-flight
        with queued, live and parked requests: on_finish fires once each,
        nothing stays parked or live, and no page stays in use outside the
        trie."""
        eng = engine(PORT, arch, prefix_cache=True)
        finished, tokens = [], []
        eng.on_finish = finished.append
        eng.on_token = lambda r, t: tokens.append((r.rid, t))
        reqs = [eng.submit(np.asarray(p, np.int32), SamplingParams(max_tokens=12))
                for p in [LONG_PROMPT] + SHORT_PROMPTS * 2]
        for _ in range(3):
            eng.step()
        live = list(eng._live.values())
        assert eng.abort(live[0])
        slot = next(iter(eng._live))
        parked = eng._live[slot]
        assert eng.preempt_slot(slot) and eng.abort(parked)
        for _ in range(4):
            eng.step()
        assert eng.preempt_slot(next(iter(eng._live)))
        assert eng._parked and eng._live and not eng._queue.empty()
        n = eng.abort_all()
        aborted = sum(r.finish_reason == "aborted" for r in reqs)
        assert n == aborted - 2 and eng.stats()["aborted"] == aborted
        assert all(r.done for r in reqs) and not eng.has_work
        assert sorted(r.rid for r in finished) == [r.rid for r in reqs]
        assert sorted(tokens) == sorted((r.rid, t) for r in reqs for t in r.output)
        if eng.pool is not None:
            eng.pool.check()
            assert eng.pool.used_pages == len(eng.trie.held_pages())

    def test_fifo_mode_unchanged_by_classes(self):
        eng = engine(PORT, "granite-8b", n_slots=1)
        first = eng.submit(np.asarray(SHORT_PROMPTS[0], np.int32),
                           SamplingParams(max_tokens=2, priority="batch"))
        second = eng.submit(np.asarray(SHORT_PROMPTS[1], np.int32),
                            SamplingParams(max_tokens=2, priority="interactive"))
        eng.run_until_drained()
        assert first.admit_step < second.admit_step

    def test_submit_rejects_unknown_class(self):
        eng = engine(PORT, "granite-8b")
        with pytest.raises(ValueError, match="priority class"):
            eng.submit(np.asarray([1, 2, 3], np.int32),
                       SamplingParams(priority="urgent"))

    def test_bounded_queue_raises_admission_queue_full(self):
        eng = engine(PORT, "granite-8b", max_queued=2)
        for _ in range(2):
            eng.submit(np.asarray([1, 2, 3], np.int32), SamplingParams(max_tokens=2))
        with pytest.raises(AdmissionQueueFull, match="max_queued 2") as ei:
            eng.submit(np.asarray([1, 2, 3], np.int32), SamplingParams(max_tokens=2))
        assert (ei.value.queued, ei.value.capacity) == (2, 2)
        eng.step()                              # both admitted: room again
        eng.submit(np.asarray([4, 5], np.int32), SamplingParams(max_tokens=2))
        eng.run_until_drained()
        st = eng.stats()
        assert st["rejected"] == 1 and st["peak_queue_depth"] == 1
        assert eng.tel.rejected.get() == 1


class TestSchedulerStats:
    def test_stats_shape_includes_scheduler_counters(self):
        eng = engine(PORT, "granite-8b")
        eng.submit(np.asarray([1, 2, 3], np.int32), SamplingParams(max_tokens=3))
        eng.run_until_drained()
        s = eng.stats()
        assert s["preempts"] == s["resumes"] == s["preempted_tokens"] == 0
        assert s["parked"] == 0 and s["work_ticks"] > 0
        assert s["preempt_free_ticks"] == s["work_ticks"]
        assert s["preempt_free_tick_rate"] == 1.0
        assert s["class_counts"] == {"batch": 1}
        assert s["class_ttft_ticks"].keys() == {"batch"}

    def test_preempt_free_ticks_counts_real_preempts(self):
        eng = engine(PORT, "granite-8b")
        eng.submit(np.asarray([1, 2, 3], np.int32), SamplingParams(max_tokens=6))
        eng.submit(np.asarray([4, 5], np.int32), SamplingParams(max_tokens=6))
        tick = 0
        while eng.has_work:
            if tick % 3 == 2:
                for slot in list(eng._live):
                    eng.preempt_slot(slot)
            eng.step()
            tick += 1
        s = eng.stats()
        assert s["preempts"] > 0 and s["resumes"] == s["preempts"]
        assert s["preempted_tokens"] > 0 and s["parked"] == 0
        assert s["preempt_free_ticks"] < s["work_ticks"]
        assert 0.0 <= s["preempt_free_tick_rate"] < 1.0

    def test_per_class_ttft_buckets_by_request_class(self):
        eng = engine(PORT, "granite-8b", priorities=True)
        eng.submit(np.asarray([1, 2, 3], np.int32),
                   SamplingParams(max_tokens=2, priority="interactive"))
        eng.submit(np.asarray([4, 5], np.int32),
                   SamplingParams(max_tokens=2, priority="batch"))
        eng.run_until_drained()
        s = eng.stats()
        assert s["class_counts"] == {"batch": 1, "interactive": 1}
        assert all(v >= 0 for v in s["class_ttft_ticks"].values())


@pytest.mark.parametrize("kw,match", [
    (dict(max_len=32, chunk_tokens=128), "exceeds max_len"),
    (dict(chunk_tokens=0), "positive"),
    (dict(chunk_tokens=-4), "positive"),
    (dict(n_slots=0), "n_slots"),
    (dict(max_len=0, chunk_tokens=1), "max_len"),
    (dict(max_len=64, chunk_tokens=8, page_tokens=0), "page_tokens"),
    (dict(max_len=64, chunk_tokens=8, page_tokens=24), "divide max_len"),
    (dict(max_len=64, chunk_tokens=8, page_tokens=16, pool_pages=3), "pool_pages"),
    (dict(prefix_nodes=0), "prefix_nodes"),
    (dict(max_queued=0), "max_queued"),
    (dict(preempt=True), "requires priorities"),
    (dict(default_priority="urgent"), "default_priority"),
    (dict(priorities=True, starvation_limit=0), "starvation_limit"),
    (dict(priorities=True, preempt=True, max_preempts=-1), "max_preempts"),
    (dict(enc_cache_entries=0), "enc_cache_entries"),
    (dict(trace_events=-1), "trace_events"),
    (dict(telemetry=False, trace_events=16), "requires telemetry"),
])
def test_serve_config_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        ServeConfig(**kw)
    ServeConfig(preempt=True, priorities=True)
    ServeConfig(max_len=64, chunk_tokens=8, page_tokens=16, pool_pages=4)
