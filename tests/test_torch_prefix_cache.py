"""The port's prefix-cache walls (counterparts of tests/test_prefix_cache.py),
at ``.reduced()`` size in f32.

Each wall runs one scenario through both packages' engines with the same
``ServeConfig`` on the same exported params (masters of ``PRNGKey(0)``; the
JAX engine on its plain reference, ``use_pallas=False``): the port's greedy
tokens, finish reasons, token steps, tick counts, prefix hits and the
prefill tokens they skipped equal the JAX engine's. Within the port, tokens
are byte-identical with the trie on and off, greedy and seeded stochastic
(the port samples stochastic rows with ``torch.Generator``, so those are
compared port against port). Covered: cold / warm / partial / unrelated
admissions on granite-8b, recurrentgemma-2b and mamba2-370m (granite also
under the xnor and int8 compute paths), post-eviction, a warm hit of a
stateful model prefilling at full chunk width, snapshot backfill, the warm
hit skipping prefill ticks, int8 K/V; pool accounting (no leaked pages,
eviction under pressure, exhaustion without a trie raises, pages a live
slot shares survive the trie's eviction); ``stats()``.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build_model as j_build_model
from repro.configs import get_config as j_get_config
from repro.nn import module as j_mod
from repro.nn.context import SERVE as J_SERVE
from repro.nn.context import TRAIN as J_TRAIN
from repro.nn.context import ModelContext as JModelContext
from repro.serve.engine import BatchedEngine as JBatchedEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.sampling import SamplingParams as JSamplingParams
from repro.serve.weights import export_serving_params as j_export
from repro_torch.configs import build_model, get_config
from repro_torch.nn.context import SERVE, ModelContext
from repro_torch.serve.engine import BatchedEngine, ServeConfig
from repro_torch.serve.prefix import PrefixTrie
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.weights import params_from_numpy

torch.set_num_threads(2)
FAMILY_ARCHS = ["granite-8b", "recurrentgemma-2b", "mamba2-370m"]
# page_tokens=4: the 14-token prompt publishes 3 complete pages and a warm
# re-admission may match at most (14 - 1) // 4 = 3 of them
PROMPT = [3, 9, 4, 11, 7, 2, 5, 1, 8, 6, 10, 12, 0, 13]
PARTIAL = PROMPT[:4] + [12, 3, 9, 1, 7]      # shares exactly page 0
OTHER = [5, 5, 2, 8, 1, 9, 4, 4, 6, 2]       # diverges at token 0
SEQUENCE = [PROMPT, PROMPT, PARTIAL, OTHER]
ENGINE = dict(n_slots=2, max_len=64, chunk_tokens=8, page_tokens=4)

# one engine API per package: the walls run the same scenario through both
JAX = types.SimpleNamespace(Engine=JBatchedEngine, Config=JServeConfig,
                            Params=JSamplingParams)
PORT = types.SimpleNamespace(Engine=BatchedEngine, Config=ServeConfig,
                             Params=SamplingParams)


@functools.lru_cache(maxsize=None)
def _export(arch, kv_dtype=None):
    """(JAX reduced config, its SERVE params from masters of PRNGKey(0))."""
    cfg = j_get_config(arch).reduced()
    if kv_dtype:
        cfg = dataclasses.replace(cfg, kv_dtype=kv_dtype)
    tm = j_build_model(cfg, JModelContext(policy=cfg.tbn, mode=J_TRAIN,
                                          compute_dtype=jnp.float32))
    sm = j_build_model(cfg, JModelContext(policy=cfg.tbn, mode=J_SERVE,
                                          compute_dtype=jnp.float32,
                                          use_pallas=False))
    tp = j_mod.init_params(tm.specs(), jax.random.PRNGKey(0))
    return cfg, j_export(tm.specs(), sm.specs(), tp, cfg.tbn)


@functools.lru_cache(maxsize=None)
def jax_model(arch, kv_dtype=None, path="float"):
    """(JAX SERVE model, params). One model object per (arch, path): its
    jitted ticks are traced once and reused by every engine on it."""
    cfg, sp = _export(arch, kv_dtype)
    return j_build_model(cfg, JModelContext(
        policy=cfg.tbn, mode=J_SERVE, compute_dtype=jnp.float32,
        use_pallas=False, compute_path=path)), sp


@functools.lru_cache(maxsize=None)
def port_model(arch, kv_dtype=None, path="float"):
    """(the port's SERVE model, the same params as torch tensors)."""
    cfg = get_config(arch).reduced()
    if kv_dtype:
        cfg = dataclasses.replace(cfg, kv_dtype=kv_dtype)
    sm = build_model(cfg, ModelContext(policy=cfg.tbn, mode=SERVE,
                                       compute_dtype=torch.float32,
                                       device="cpu", compute_path=path))
    return sm, params_from_numpy(jax.tree.map(np.asarray, _export(arch, kv_dtype)[1]),
                                 "cpu")


def engine(pkg, arch, kv_dtype=None, path="float", **cfg_over):
    sm, sp = (jax_model if pkg is JAX else port_model)(arch, kv_dtype, path)
    kw = dict(ENGINE, compute_path=path)
    kw.update(cfg_over)
    return pkg.Engine(sm, sp, pkg.Config(**kw))


def summary(reqs, ticks):
    """What both packages must agree on: tokens, finish reasons, token
    steps, prefix hits per request, and the tick counts."""
    return ([r.output for r in reqs], [r.finish_reason for r in reqs],
            [r.token_steps for r in reqs], [r.prefix_hit_tokens for r in reqs],
            ticks)


def drain_sequence(pkg, arch, prompts, *, max_tokens=5, kv_dtype=None,
                   path="float", **cfg_over):
    """Submit and drain each prompt in order on ONE engine (so later prompts
    see what earlier ones published). -> (engine, summary)."""
    eng = engine(pkg, arch, kv_dtype, path, **cfg_over)
    reqs, ticks = [], []
    for p in prompts:
        reqs.append(eng.submit(np.asarray(p, np.int32),
                               pkg.Params(max_tokens=max_tokens)))
        ticks.append(eng.run_until_drained())
    return eng, summary(reqs, ticks)


def hit_stats(eng):
    st = eng.stats()
    return st["prefix_hits"], st["prefill_tokens_skipped"]


@functools.lru_cache(maxsize=None)
def _jax_sequence(arch, kv_dtype=None, path="float"):
    eng, got = drain_sequence(JAX, arch, SEQUENCE, kv_dtype=kv_dtype, path=path,
                              prefix_cache=True)
    return got, hit_stats(eng)


class TestPrefixParityWall:
    """Request 0 is the cold miss (and the publisher), request 1 the warm
    hit, request 2 the partial hit, request 3 an unrelated miss."""

    @pytest.mark.parametrize("arch,path", [(a, "float") for a in FAMILY_ARCHS]
                             + [("granite-8b", "xnor"), ("granite-8b", "int8")])
    def test_greedy_cold_warm_partial_equals_reference(self, arch, path):
        eng, on = drain_sequence(PORT, arch, SEQUENCE, path=path,
                                 prefix_cache=True)
        assert (on, hit_stats(eng)) == _jax_sequence(arch, path=path)
        # warm maps 3 pages (12 tokens), partial page 0 (4 tokens)
        assert hit_stats(eng) == (2, 16)
        assert [r for r in on[3]] == [0, 12, 4, 0]
        _, off = drain_sequence(PORT, arch, SEQUENCE, path=path,
                                prefix_cache=False)
        assert on[0] == off[0] and on[1] == off[1]
        assert len(eng.trie) > 0

    @pytest.mark.parametrize("arch", FAMILY_ARCHS)
    def test_seeded_stochastic_on_equals_off(self, arch):
        """The sampler draws token t from (seed, rid, t) alone: a hit
        replays the stream the cold path would have drawn."""
        def run(on):
            eng = engine(PORT, arch, prefix_cache=on, seed=3)
            outs = []
            for p in SEQUENCE:
                r = eng.submit(np.asarray(p, np.int32), SamplingParams(
                    max_tokens=7, temperature=1.0, top_k=5))
                eng.run_until_drained()
                outs.append(r.output)
            return outs

        on = run(True)
        assert on == run(False)
        assert len({tuple(o) for o in on}) > 1

    def test_int8_kv_equals_reference(self):
        """int8 codes and scales page together: a shared prefix replays
        bit-identical codes."""
        eng, on = drain_sequence(PORT, "granite-8b", SEQUENCE, kv_dtype="int8",
                                 prefix_cache=True)
        assert (on, hit_stats(eng)) == _jax_sequence("granite-8b", "int8")
        _, off = drain_sequence(PORT, "granite-8b", SEQUENCE, kv_dtype="int8",
                                prefix_cache=False)
        assert on[0] == off[0] and hit_stats(eng) == (2, 16)

    @pytest.mark.parametrize("arch", FAMILY_ARCHS)
    def test_post_eviction_equals_reference(self, arch):
        """After the trie is drained a re-admission is a cold miss again and
        emits the same tokens, in both packages."""
        def run(pkg):
            eng, first = drain_sequence(pkg, arch, [PROMPT, PROMPT],
                                        prefix_cache=True)
            assert hit_stats(eng)[0] == 1
            eng.trie.clear()
            assert len(eng.trie) == 0
            r = eng.submit(np.asarray(PROMPT, np.int32), pkg.Params(max_tokens=5))
            ticks = eng.run_until_drained()
            if eng.pool is not None:
                eng.pool.check()
                assert eng.pool.used_pages == len(eng.trie.held_pages()) == 3
            return first, summary([r], [ticks])

        first, again = run(PORT)
        assert again[3] == [0] and again[0] == [first[0][0]]
        assert (first, again) == run(JAX)

    def test_stateful_warm_hit_prefills_at_full_chunk_width(self):
        """A cold stateful prefill steps one page per tick (each boundary
        snapshotted); a warm full-hit repeat has nothing to snapshot and
        lands its whole tail in one chunk."""
        def run(pkg):
            cfg = _export("mamba2-370m")[0]
            prompt = np.asarray([x % cfg.vocab for x in range(40)], np.int32)
            eng = engine(pkg, "mamba2-370m", n_slots=1, chunk_tokens=16,
                         prefix_cache=True)
            a = eng.submit(prompt, pkg.Params(max_tokens=2))
            eng.run_until_drained()
            b = eng.submit(prompt, pkg.Params(max_tokens=2))
            eng.run_until_drained()
            return (a.token_steps[0] - a.admit_step + 1,
                    b.token_steps[0] - b.admit_step + 1,
                    b.prefix_hit_tokens, a.output, b.output)

        got = run(PORT)
        assert got[:3] == (10, 1, 36) and got[3] == got[4]
        assert got == run(JAX)

    def test_snapshot_backfill_on_republish(self):
        """A node published without a snapshot regains one on the next
        publish that carries it."""
        trie = PrefixTrie(2, pool=None, max_nodes=8)
        seq = [1, 2, 3, 4]
        trie.insert(seq, None, {}, now=0)
        assert trie.match(seq + [9], require_snapshot=True) == []
        snap = {"h": torch.ones(3)}
        trie.insert(seq, None, {2: {"h": torch.zeros(3)}, 4: snap}, now=1)
        path = trie.match(seq + [9], require_snapshot=True)
        assert len(path) == 2 and path[-1].snapshot is snap
        assert trie.snapshot_bytes() == 2 * 3 * 4

    def test_warm_hit_skips_prefill_work(self):
        """14-token prompt, chunk 8: cold = 2 extend ticks; warm maps 12
        tokens and finishes prefill in 1."""
        def run(pkg):
            eng = engine(pkg, "granite-8b", n_slots=1, prefix_cache=True)
            a = eng.submit(np.asarray(PROMPT, np.int32), pkg.Params(max_tokens=2))
            eng.run_until_drained()
            b = eng.submit(np.asarray(PROMPT, np.int32), pkg.Params(max_tokens=2))
            eng.run_until_drained()
            return (a.token_steps[0] - a.admit_step,
                    b.token_steps[0] - b.admit_step, b.prefix_hit_tokens,
                    a.output, b.output)

        cold, warm, hit, a, b = got = run(PORT)
        assert hit == 12 and warm < cold and a == b
        assert got == run(JAX)


class TestPoolAccounting:
    def test_no_leaked_pages_after_drain(self):
        """After every request retires the only references left are the
        trie's pins; clearing the trie frees the whole pool."""
        eng, _ = drain_sequence(PORT, "granite-8b", SEQUENCE, prefix_cache=True)
        eng.pool.check()
        assert eng.pool.used_pages == len(eng.trie.held_pages())
        eng.trie.clear()
        eng.pool.check()
        assert eng.pool.used_pages == 0 and eng.pool.free_pages == eng.pool.n_pages

    def test_no_leaked_pages_without_prefix_cache(self):
        eng, _ = drain_sequence(PORT, "granite-8b", [PROMPT, OTHER],
                                prefix_cache=False)
        eng.pool.check()
        assert eng.pool.used_pages == 0

    def test_trie_eviction_reclaims_pages_under_pressure(self):
        """A pool of one slot's worth: the second prompt's pages can only
        come from evicting the first prompt's nodes; both packages drain
        with the same tokens and evictions."""
        def run(pkg):
            vocab = _export("granite-8b")[0].vocab
            eng = engine(pkg, "granite-8b", n_slots=1, pool_pages=16,
                         prefix_cache=True)
            a = eng.submit(np.asarray([x % vocab for x in range(1, 61)], np.int32),
                           pkg.Params(max_tokens=2))
            eng.run_until_drained()
            nodes = len(eng.trie)
            b = eng.submit(np.asarray([x % vocab for x in range(70, 130)], np.int32),
                           pkg.Params(max_tokens=2))
            eng.run_until_drained()
            eng.pool.check()
            return nodes, a.output, b.output, a.done and b.done, eng.trie.evictions

        got = run(PORT)
        assert got[0] == 15 and got[3] and got[4] > 0
        assert got == run(JAX)

    def test_pool_exhaustion_without_trie_raises(self):
        """No prefix cache, nothing to evict: prompts that overcommit the
        pool fail loudly, naming the fix."""
        eng = engine(PORT, "granite-8b", page_tokens=16, pool_pages=4,
                     prefix_cache=False)
        eng.submit(np.arange(1, 41, dtype=np.int32), SamplingParams(max_tokens=20))
        eng.submit(np.arange(1, 41, dtype=np.int32), SamplingParams(max_tokens=20))
        with pytest.raises(RuntimeError, match="pool exhausted.*raise pool_pages"):
            eng.run_until_drained()

    def test_shared_pages_survive_trie_eviction_while_slot_lives(self):
        """Evicting a node whose pages a live slot maps keeps them (the
        slot's reference) until the slot retires."""
        eng = engine(PORT, "granite-8b", n_slots=1, prefix_cache=True)
        a = eng.submit(np.asarray(PROMPT, np.int32), SamplingParams(max_tokens=2))
        eng.run_until_drained()
        b = eng.submit(np.asarray(PROMPT, np.int32), SamplingParams(max_tokens=8))
        eng.step()
        held = int(eng._n_mapped[0])
        assert held >= 3
        eng.trie.clear()
        assert all(eng.pool.refcounts[int(eng._ptab[0, i])] >= 1
                   for i in range(held))
        eng.run_until_drained()
        assert b.output[:2] == a.output
        eng.pool.check()
        # b's retirement republished its 3 pages; nothing else is held
        assert eng.pool.used_pages == len(eng.trie.held_pages()) == 3


class TestStats:
    def test_stats_shape_and_ranges(self):
        eng, _ = drain_sequence(PORT, "granite-8b", [PROMPT, PROMPT],
                                prefix_cache=True)
        st = eng.stats()
        assert st["admitted"] == 2 and st["hit_rate"] == 0.5
        assert st["prefix_hits"] == 1
        assert st["prefix_tokens"] == st["prefill_tokens_skipped"] == 12
        assert st["prompt_tokens"] == 2 * len(PROMPT)
        assert 0.0 <= st["page_utilization"] <= 1.0
        assert st["pages_in_use"] <= st["pool_pages"]
        assert st["evictions"] == 0 and st["trie_nodes"] == 3
        assert st["trie_snapshot_bytes"] == 0      # stateless: pages only

    def test_stats_without_prefix_cache(self):
        eng, _ = drain_sequence(PORT, "granite-8b", [PROMPT], prefix_cache=False)
        st = eng.stats()
        assert st["prefix_hits"] == 0 and st["hit_rate"] == 0.0
        assert st["trie_nodes"] == 0 and st["evictions"] == 0

    def test_stateful_trie_holds_snapshot_bytes(self):
        """A stateful model's nodes own cloned snapshots: their bytes are
        reported, and the pinned tensors are not the engine's caches."""
        eng, _ = drain_sequence(PORT, "mamba2-370m", [PROMPT], prefix_cache=True)
        snap = eng.trie._nodes[0].snapshot
        held = [t for seg in snap for t in seg.values() if t is not None]
        per_node = sum(t.numel() * t.element_size() for t in held)
        assert eng.stats()["trie_snapshot_bytes"] == 3 * per_node > 0
        cache_ptrs = {t.data_ptr() for c in eng.caches for t in c.values()}
        assert not cache_ptrs & {t.data_ptr() for t in held}
