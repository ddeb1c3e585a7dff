"""The engine's reuse and scheduling features on the card, on ``.reduced()``
configs in bf16: the captured slot snapshot and restore (no aliasing of a
graph's static output, restore equal to the eager one) and preempt-and-
resume leaving greedy tokens unchanged, cold and warm.

Imports neither jax nor the JAX package, so it runs on the GPU machine:

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_engine_features_cuda.py

Every test is marked ``cuda`` and skips, from a fixture, on a host without
a CUDA device."""
import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (kernels B1-B4 have no CPU mode)")
    return torch.device("cuda")


def _serving(arch):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_serving

    cfg = get_config(arch).reduced()
    model, sp, _ = build_serving(cfg, device="cuda", seed=0)
    return cfg, model, sp


def _engine(model, sp, **kw):
    from repro_torch.serve.engine import BatchedEngine, ServeConfig

    return BatchedEngine(model, sp, ServeConfig(**{
        **dict(n_slots=3, max_len=48, chunk_tokens=8, page_tokens=8), **kw}))


def _leaves(tree):
    if isinstance(tree, list):
        return [t for x in tree for t in _leaves(x)]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [] if tree is None else [tree]


def _prompts(cfg, lens=(5, 11, 19, 9)):
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in lens]


def _drive(eng, prompts, preempt_every=0):
    from repro_torch.serve.sampling import SamplingParams

    reqs = [eng.submit(p, SamplingParams(max_tokens=6)) for p in prompts]
    i = 0
    while eng.has_work:
        assert i < 500
        if preempt_every and i % preempt_every == preempt_every - 1:
            for slot in list(eng._live):
                assert eng.preempt_slot(slot)
        eng.step()
        i += 1
    return [r.output for r in reqs]


@pytest.mark.cuda
def test_captured_snapshot_does_not_alias_later_replays(cuda_device):
    """Snapshots taken through the captured graph stay equal to the eager
    snapshot of the same rows after later replays overwrite the graph's
    static output."""
    cfg, model, sp = _serving("mamba2-370m")
    eng = _engine(model, sp, prefix_cache=True)
    _drive(eng, _prompts(cfg)[:3])           # every slot's rows are non-zero
    eager = [eng._snapshot(s) for s in range(3)]
    assert {"snapshot_slot", "restore_slot"} <= set(eng.warmup())
    captured = [eng._snapshot(s) for s in range(3)]
    for s in (2, 0, 1):                      # replays after the fact
        eng._snapshot(s)
    torch.cuda.synchronize()
    for s in range(3):
        for a, b in zip(_leaves(eager[s]), _leaves(captured[s]), strict=True):
            assert torch.equal(a, b)
    out = eng._graphs["snapshot_slot"].output
    held = {t.data_ptr() for c in captured for t in _leaves(c)}
    assert not held & {t.data_ptr() for t in _leaves(out)}


@pytest.mark.cuda
def test_captured_restore_equals_eager_restore(cuda_device):
    """A restore replayed from its graph writes the slot's per-slot rows
    exactly as the eager restore does, and leaves the other slots alone."""
    cfg, model, sp = _serving("mamba2-370m")
    cold = _engine(model, sp, prefix_cache=True)
    warm = _engine(model, sp, prefix_cache=True)
    for eng in (cold, warm):
        _drive(eng, _prompts(cfg)[:3])
    src = cold._snapshot(0)
    warm.warmup()
    others = [[t.clone() for t in _leaves(warm._snapshot(s))] for s in (0, 2)]
    cold._restore(1, src)
    warm._restore(1, src)
    eager, replayed = cold._snapshot(1), warm._snapshot(1)
    torch.cuda.synchronize()
    for a, b, c in zip(_leaves(eager), _leaves(replayed), _leaves(src), strict=True):
        assert torch.equal(a, b) and torch.equal(b, c)
    for before, s in zip(others, (0, 2)):
        for a, b in zip(before, _leaves(warm._snapshot(s)), strict=True):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-370m", "granite-8b"])
def test_preempt_resume_keeps_greedy_tokens(cuda_device, arch):
    """Every live slot parked every third tick, cold and warm (the snapshot
    and restore replayed): the greedy tokens of a run that is never
    preempted; every page back in the pool."""
    cfg, model, sp = _serving(arch)
    prompts = _prompts(cfg)
    base = _drive(_engine(model, sp), prompts)
    for warm in (False, True):
        eng = _engine(model, sp, priorities=True, preempt=True)
        if warm:
            eng.warmup()
        assert _drive(eng, prompts, preempt_every=3) == base
        st = eng.stats()
        assert st["preempts"] > 0 and st["resumes"] == st["preempts"]
        if eng.pool is not None:
            eng.pool.check()
            assert eng.pool.used_pages == 0
