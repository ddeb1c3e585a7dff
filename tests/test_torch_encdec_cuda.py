"""The encoder-decoder family on the card: seamless-m4t-large-v2
``.reduced()`` served by the engine cold and warm (the encode tick replayed
from a CUDA graph beside the decode and extend ticks), its launch counts,
and the model and the engine on the card against the CPU.

Imports neither jax nor the JAX package, so it runs on the GPU machine:

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_encdec_cuda.py

Every test is marked ``cuda`` and skips, from a fixture, on a host without
a CUDA device."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import tiled_xnor as x8
from repro_torch.kernels.tiled_matmul import tiled_matmul_unique
from repro_torch.kernels.tiled_matvec import tiled_matvec_unique

ARCH = "seamless-m4t-large-v2"
# m = 48 rows an encode tick: more than a decode kernel takes, so B2
ENC_TOKENS = 48
WRAPPERS = (tiled_matvec_unique, tiled_matmul_unique,
            x8.tiled_xnor_matvec_unique, x8.tiled_int8_matvec_unique)
OWN = {"float": tiled_matvec_unique, "xnor": x8.tiled_xnor_matvec_unique,
       "int8": x8.tiled_int8_matvec_unique}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (kernels B1-B4 have no CPU mode)")
    return torch.device("cuda")


def _serving(path, device="cuda", dtype=torch.bfloat16):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_serving

    cfg = get_config(ARCH).reduced()
    model, sp, _ = build_serving(cfg, device=device, seed=0, compute_path=path,
                                 compute_dtype=dtype)
    return cfg, model, sp


def _engine(model, sp, path):
    from repro_torch.serve.engine import BatchedEngine, ServeConfig

    return BatchedEngine(model, sp, ServeConfig(
        n_slots=2, max_len=48, chunk_tokens=24, page_tokens=8, compute_path=path,
        enc_tokens=ENC_TOKENS))


def _jobs(cfg):
    rng = np.random.default_rng(0)
    return [(rng.integers(0, cfg.vocab, size=n),
             rng.standard_normal((f, cfg.d_model)).astype(np.float32))
            for n, f in ((5, 40), (11, 7), (19, 48), (3, 23))]


def _serve(eng, jobs):
    from repro_torch.serve.sampling import SamplingParams

    reqs = [eng.submit(p, SamplingParams(max_tokens=6), frames=f) for p, f in jobs]
    ticks = eng.run_until_drained()
    return [r.output for r in reqs], [r.token_steps for r in reqs], ticks


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["float", "xnor", "int8"])
def test_encdec_warm_engine_replays_cold_tokens_on_card(cuda_device, path):
    """bf16 on the card, cold and then warm (decode, extend and encode
    ticks replayed): equal greedy tokens, token steps and ticks; the warm
    drain moves no launch counter and no TRACE_COUNTS, encode_tick
    included; every cross page back at refcount 0."""
    from repro_torch.serve.engine import TRACE_COUNTS

    cfg, model, sp = _serving(path)
    jobs = _jobs(cfg)
    runs = []
    for warm in (False, True):
        eng = _engine(model, sp, path)
        if warm:
            assert set(eng.warmup()) == {"decode_tick", "extend_tick", "encode_tick"}
        launches = [fn.launches for fn in WRAPPERS]
        traces = TRACE_COUNTS.copy()
        runs.append(_serve(eng, jobs))
        moved = [fn.launches - n for fn, n in zip(WRAPPERS, launches)]
        if warm:
            assert moved == [0] * len(WRAPPERS) and TRACE_COUNTS == traces
        else:
            assert TRACE_COUNTS["encode_tick"] == traces["encode_tick"] + len(jobs)
        assert eng.stats()["encode_ticks"] == len(jobs)
        assert not eng.xpool.refcounts.any() and eng.pool.used_pages == 0
    assert runs[0] == runs[1]


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["float", "xnor", "int8"])
def test_encdec_tick_launch_counts(cuda_device, path):
    """An encode tick launches B2 once per projection at m = ENC_TOKENS
    (frame_proj, each encoder layer's q, k, v, o, up, down, each decoder
    layer's cross k, v), an extend tick once per decoder-layer projection
    and the decode kernel for its head; a decode-only tick launches the
    path's decode kernel once per decoder-layer projection (self q, k, v,
    o, cross q, o, up, down) and once for the head (the reduced
    vocabulary, 512, is a multiple of p: a tile), and nothing else."""
    cfg, model, sp = _serving(path)
    eng = _engine(model, sp, path)
    for p, f in _jobs(cfg)[:2]:
        eng.submit(p, frames=f)
    before = [fn.launches for fn in WRAPPERS]
    eng.step()                                   # encode + the first chunk
    torch.cuda.synchronize()
    assert eng.stats()["encode_ticks"] == 1 and eng.stats()["extend_ticks"] == 1
    moved = {fn: fn.launches - n for fn, n in zip(WRAPPERS, before)}
    # the extend tick: every decoder-layer projection at m = 2 * 24 (B2),
    # the head on its 2 last-column rows (the decode kernel)
    extend_b2 = 8 * cfg.dec_layers
    assert moved[tiled_matmul_unique] == (1 + 6 * cfg.enc_layers
                                          + 2 * cfg.dec_layers + extend_b2)
    assert moved[OWN[path]] == 1
    while eng._phase.count("decode") < 2:
        eng.step()
    before = [fn.launches for fn in WRAPPERS]
    st = eng.stats()
    eng.step()                                   # one decode-only tick
    torch.cuda.synchronize()
    assert eng.stats()["extend_ticks"] == st["extend_ticks"]
    moved = {fn: fn.launches - n for fn, n in zip(WRAPPERS, before)}
    assert moved[OWN[path]] == 8 * cfg.dec_layers + 1
    assert all(v == 0 for fn, v in moved.items() if fn is not OWN[path])


@pytest.mark.cuda
def test_encdec_model_on_card_matches_cpu(cuda_device):
    """f32, card against CPU on one export: two slots encode 40 and 7
    frames through their cross rows, extend 11 and 5 tokens, then two
    decode steps; logits and both pools within 1e-4."""
    from repro_torch.configs import build_model
    from repro_torch.nn import module as mod
    from repro_torch.nn.context import SERVE, ModelContext

    cfg, _, sp = _serving("float", device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(3)
    enc_lens = np.array([40, 7], np.int32)
    frames = rng.standard_normal((2, ENC_TOKENS, cfg.d_model)).astype(np.float32)
    valid = np.arange(ENC_TOKENS)[None, :] < enc_lens[:, None]
    frames *= valid[..., None]
    xptab = np.array([[4, 0, 2, 6, 8, 10], [1, 3, 5, 7, 9, 11]], np.int32)
    toks = rng.integers(0, cfg.vocab, (2, 11))
    out = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, ModelContext(policy=cfg.tbn, mode=SERVE,
                                              compute_dtype=torch.float32,
                                              device=dev))
        params = mod.map_tree(lambda v: v.to(dev), sp)
        caches = model.init_caches(2, 48, torch.float32, page_tokens=8, n_pages=12,
                                   cross_pages=12)
        t = {k: torch.from_numpy(v).to(dev) for k, v in (
            ("frames", frames), ("valid", valid), ("xptab", xptab),
            ("enc_lens", enc_lens), ("toks", toks))}
        cross = dict(cross_page_table=t["xptab"], enc_lens=t["enc_lens"])
        ptab = torch.arange(12, dtype=torch.int32, device=dev).reshape(2, 6)
        pos = torch.arange(ENC_TOKENS, device=dev)[None, :]
        lengths = torch.zeros(2, dtype=torch.int32, device=dev)
        logits = []
        with torch.no_grad():
            for b in range(2):
                mem = model.encode_serve(params, t["frames"][b:b + 1],
                                         t["valid"][b:b + 1])
                model.write_cross(params, mem, caches, t["xptab"][b:b + 1], pos,
                                  t["valid"][b:b + 1])
            lg, caches, lengths = model.extend(
                params, t["toks"], caches, lengths,
                torch.tensor([11, 5], dtype=torch.int32, device=dev), ptab, **cross)
            logits.append(lg.cpu())
            tok = torch.tensor([[1], [2]], device=dev)
            for _ in range(2):
                lg, caches, lengths = model.decode_step(params, tok, caches, lengths,
                                                        ptab, **cross)
                logits.append(lg.cpu())
        out[dev] = logits + [v[:, :-1].cpu() for _, v in mod.walk(caches)]
    for got, want in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_encdec_engine_on_card_gives_the_cpu_tokens(cuda_device):
    """f32 engines on one export, on the card and on the CPU: the same
    greedy tokens, token steps and ticks."""
    from repro_torch.configs import build_model
    from repro_torch.nn import module as mod
    from repro_torch.nn.context import SERVE, ModelContext

    cfg, cpu_model, sp = _serving("float", device="cpu", dtype=torch.float32)
    card_model = build_model(cfg, ModelContext(policy=cfg.tbn, mode=SERVE,
                                               compute_dtype=torch.float32,
                                               device="cuda"))
    jobs = _jobs(cfg)
    cpu = _serve(_engine(cpu_model, sp, "float"), jobs)
    card = _serve(_engine(card_model, mod.map_tree(lambda v: v.to("cuda"), sp),
                          "float"), jobs)
    assert card == cpu
