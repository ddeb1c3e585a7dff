"""The port's EncoderCache walls (counterparts of tests/test_encdec_serve.py's
warm encoder reuse, preempt-and-resume and distinct-source walls), on
seamless-m4t-large-v2 ``.reduced()`` in f32.

With ``prefix_cache`` on, a cross model keeps the token trie off and reuses
encoder outputs: a source whose digest the EncoderCache holds maps its
cross-page run into the slot and skips ENCODE (at admission, or late, in
``step()``, when the source's first encode ran after the request was
admitted). Each wall gives the JAX engine's greedy tokens, finish reasons,
token steps, ticks, encode ticks and cache hits on the same params and
``ServeConfig`` under every compute path; within the port the tokens equal
the cache-off run's, greedy and seeded stochastic, and parking a request
never re-encodes its source.
"""
import functools

import numpy as np
import pytest

from test_torch_prefix_cache import JAX, PORT, _export, engine

ARCH = "seamless-m4t-large-v2"
PROMPTS = [[3, 9, 4, 11, 7, 2, 5], [8, 6, 1, 12, 0], [5, 5, 2, 8]]
ENGINE = dict(n_slots=2, max_len=64, chunk_tokens=8, page_tokens=8,
              enc_tokens=16, prefix_cache=True)
PATHS = ("float", "xnor", "int8")


@functools.lru_cache(maxsize=None)
def sources():
    """Two distinct source clips (11 and 5 frames)."""
    rng = np.random.default_rng(7)
    d = _export(ARCH)[0].d_model
    return tuple(rng.standard_normal((n, d)).astype(np.float32) for n in (11, 5))


def run(pkg, jobs, *, path="float", preempt_every=0, params=None, **cfg_over):
    """Drain [(prompt, frames), ...] -> (engine, requests, summary)."""
    eng = engine(pkg, ARCH, path=path, **dict(ENGINE, **cfg_over))
    reqs = [eng.submit(np.asarray(p, np.int32),
                       pkg.Params(max_tokens=6, **(params or {})), frames=f)
            for p, f in jobs]
    i = 0
    while eng.has_work:
        assert i < 800, "engine wedged"
        if preempt_every and i % preempt_every == preempt_every - 1:
            for slot in list(eng._live):
                assert eng.preempt_slot(slot)
        eng.step()
        i += 1
    st = eng.stats()
    return eng, reqs, ([r.output for r in reqs], [r.finish_reason for r in reqs],
                       [r.token_steps for r in reqs], [r.enc_reused for r in reqs],
                       i, st["encode_ticks"], st["enc_cache_hits"],
                       st["preempts"], st["resumes"])


@pytest.mark.parametrize("path", PATHS)
def test_warm_encoder_reuse_equals_reference(path):
    """Three requests over one source: one encode, two hits (the third
    admitted warm, the second a late hit), the JAX engine's tokens, and
    the cache-off tokens."""
    frames = sources()[0]
    jobs = [(p, frames) for p in PROMPTS]
    eng, reqs, got = run(PORT, jobs, path=path)
    assert got == run(JAX, jobs, path=path)[2]
    assert got[5] == 1 and got[6] == len(PROMPTS) - 1
    assert all(r.enc_reused for r in reqs[1:])
    _, _, off = run(PORT, jobs, path=path, prefix_cache=False)
    assert off[0] == got[0] and off[5] == len(PROMPTS) and off[6] == 0
    assert eng.trie is None and eng.stats()["enc_cache_entries"] == 1
    # only the cache's entry still holds cross pages
    eng.xpool.check()
    assert eng.xpool.used_pages == len(eng.enc_cache.held_pages()) == 2


@pytest.mark.parametrize("params", [None, dict(temperature=0.9, top_k=12)],
                         ids=["greedy", "stochastic"])
def test_preempt_resume_never_reencodes(params):
    """Parking keeps the cross pages; resuming rewrites the cross table
    row, so the chaos run encodes as often as the calm one and gives its
    tokens (greedy: also the JAX engine's summary)."""
    src = sources()
    jobs = [(p, src[i % 2]) for i, p in enumerate(PROMPTS)]
    _, _, base = run(PORT, jobs, params=params)
    _, _, got = run(PORT, jobs, params=params, preempt_every=3)
    assert got[0] == base[0] and got[5] == base[5]
    assert got[7] > 0 and got[8] == got[7]
    if params is None:
        assert got == run(JAX, jobs, preempt_every=3)[2]


def test_distinct_sources_are_not_shared():
    """The same prompt over two sources decodes differently: no hit, and
    the token trie is off for a cross model."""
    a, b = sources()
    jobs = [(PROMPTS[0], a), (PROMPTS[0], b)]
    eng, _, got = run(PORT, jobs)
    assert got[0][0] != got[0][1] and got[6] == 0 and eng.trie is None
    assert got == run(JAX, jobs)[2]
