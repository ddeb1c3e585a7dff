"""Port parity for the rest of the dense family: the minitron-8b,
starcoder2-7b and qwen1.5-32b configs, the int8 KV cache (``quantize_kv``,
``dequantize_kv``, ``Attention.extend_quant`` / ``decode_step_quant`` and
the int8 pools of ``DecoderLM``), the reference's int8 KV walls, and the
streamed ``build_serving``. The same numpy inputs and JAX-exported weights
go to both packages, at ``.reduced()`` size, in f32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build_model as j_build_model
from repro.configs import get_config as j_get_config
from repro.core.policy import fp32_policy as j_fp32_policy
from repro.nn import attention as j_attn
from repro.nn import module as j_mod
from repro.nn.context import SERVE as J_SERVE
from repro.nn.context import TRAIN as J_TRAIN
from repro.nn.context import ModelContext as JModelContext
from repro.serve.sampling import sample_logits_batch as j_sample_batch
from repro.serve.weights import export_serving_params as j_export
from repro_torch.configs import ARCH_IDS, build_model, get_config
from repro_torch.core.policy import fp32_policy
from repro_torch.launch import serve as serve_cli
from repro_torch.nn import attention as attn
from repro_torch.nn import module as mod
from repro_torch.nn.context import SERVE, TRAIN, ModelContext
from repro_torch.serve.engine import BatchedEngine, ServeConfig
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.weights import (
    export_serving_params,
    params_from_numpy,
    serving_bytes,
)
from test_torch_weights import CONFIG_FIELDS

torch.set_num_threads(2)
NEW_ARCHS = ("minitron-8b", "starcoder2-7b", "qwen1.5-32b")
DENSE_ARCHS = ("granite-8b",) + NEW_ARCHS


def _j_serve(arch, key=0, path="float", **over):
    """(JAX reduced config, SERVE model, SERVE params exported from masters
    of PRNGKey(key)), f32, the Pallas kernels off (their plain versions)."""
    cfg = j_get_config(arch).reduced()
    if over:
        cfg = dataclasses.replace(cfg, **over)
    tm = j_build_model(cfg, JModelContext(policy=cfg.tbn, mode=J_TRAIN,
                                          compute_dtype=jnp.float32))
    sm = j_build_model(cfg, JModelContext(policy=cfg.tbn, mode=J_SERVE,
                                          compute_dtype=jnp.float32,
                                          use_pallas=False, compute_path=path))
    masters = j_mod.init_params(tm.specs(), jax.random.PRNGKey(key))
    return cfg, sm, j_export(tm.specs(), sm.specs(), masters, cfg.tbn)


def _t_serve(arch, sp_j, path="float", **over):
    """The port's SERVE model of the same config and the JAX params."""
    cfg = get_config(arch).reduced()
    if over:
        cfg = dataclasses.replace(cfg, **over)
    sm = build_model(cfg, ModelContext(policy=cfg.tbn, mode=SERVE,
                                       compute_dtype=torch.float32,
                                       device="cpu", compute_path=path))
    return sm, params_from_numpy(jax.tree.map(np.asarray, sp_j), "cpu")


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_matches_reference(arch, reduced):
    cj, ct = j_get_config(arch), get_config(arch)
    if reduced:
        cj, ct = cj.reduced(), ct.reduced()
    for f in CONFIG_FIELDS + ("grad_accum",):
        assert getattr(ct, f) == getattr(cj, f), f
    assert dataclasses.asdict(ct.tbn) == dataclasses.asdict(cj.tbn)


def test_every_dense_arch_is_registered():
    assert set(DENSE_ARCHS) <= set(ARCH_IDS)
    cfg = get_config("qwen1.5-32b")
    assert (cfg.n_layers, cfg.d_model, cfg.kv_dtype) == (64, 5120, "int8")


def test_int8_kv_config_builds_int8_pools():
    cfg = get_config("qwen1.5-32b").reduced()
    sm = build_model(cfg, ModelContext(policy=cfg.tbn, mode=SERVE,
                                       compute_dtype=torch.float32, device="cpu"))
    (cache,) = sm.init_caches(1, 40, torch.float32, page_tokens=8, n_pages=5)
    hd = cfg.head_dim
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == {
        "k": ((2, 6, 8, 2, hd), torch.int8), "v": ((2, 6, 8, 2, hd), torch.int8),
        "ks": ((2, 6, 8, 2), torch.float32), "vs": ((2, 6, 8, 2), torch.float32)}
    bad = dataclasses.replace(cfg, kv_dtype="fp8")
    with pytest.raises(ValueError, match="kv_dtype"):
        build_model(bad, ModelContext(policy=bad.tbn, device="cpu"))


# --------------------------------------------------------------------------
# quantize_kv / dequantize_kv
# --------------------------------------------------------------------------
def _kv_rows(dtype):
    """(2, 6, 3, 16) K/V-shaped rows: random rows, an all-zero row, and rows
    whose x / scale lands on .5 (amax 127 gives scale 1; amax 254 scale 2),
    in ``dtype``, as a JAX array and the same bits as a torch tensor."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 3, 16)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0
    x[0, 1, 1] = [127, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5,
                  4.5, -4.5, 5.5, 0, 63.5, -63.5, 100.5, -127]
    x[1, 2, 2] = [254, 5, -7, 1, -1, 3, 253, -253, 9, -9, 11, 0, 127,
                  -127, 201, -254]
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    return jx, params_from_numpy({"x": np.asarray(jx)}, "cpu")["x"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_matches_reference(dtype):
    jx, tx = _kv_rows(dtype)
    jq, js = j_attn.quantize_kv(jx)
    tq, ts = attn.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # the .5 rows round half to even, the zero row takes the 1e-8 floor
    assert tq[0, 1, 1, :3].tolist() == [127, 2, -4]
    assert float(ts[0, 0, 0]) == np.float32(1e-8) / np.float32(127.0)


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_kv_matches_reference(dtype, out):
    jx, tx = _kv_rows(dtype)
    jd = j_attn.dequantize_kv(*j_attn.quantize_kv(jx), getattr(jnp, out))
    td = attn.dequantize_kv(*attn.quantize_kv(tx), getattr(torch, out))
    assert td.dtype == getattr(torch, out)
    np.testing.assert_array_equal(td.float().numpy(),
                                  np.asarray(jd).astype(np.float32))


def test_quant_roundtrip_exact_for_updates():
    """Requantizing the dequantized cache gives back the codes exactly (the
    reference's wall, tests/test_serve.py TestInt8KV)."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 8, 4, 16)).astype(np.float32))
    q, s = attn.quantize_kv(x)
    q2, s2 = attn.quantize_kv(attn.dequantize_kv(q, s, torch.float32))
    assert torch.equal(q, q2)
    np.testing.assert_allclose(s.numpy(), s2.numpy(), rtol=1e-6)


# --------------------------------------------------------------------------
# Attention.extend_quant / decode_step_quant on a paged pool
# --------------------------------------------------------------------------
def _exact_attention_params(rng, d, n_heads, n_kv, hd):
    """Weights and biases that are small multiples of 1/16: with inputs that
    are multiples of 1/8, every projection is exact in f32 in any summation
    order, so both packages quantize the very same K/V rows."""
    def dense(n_out, n_in, bias=True):
        p = {"w": rng.integers(-4, 5, (n_out, n_in)).astype(np.float32) / 16}
        if bias:
            p["b"] = rng.integers(-4, 5, (n_out,)).astype(np.float32) / 16
        return p

    return {"wq": dense(n_heads * hd, d), "wk": dense(n_kv * hd, d),
            "wv": dense(n_kv * hd, d), "wo": dense(d, n_heads * hd, False)}


def test_attention_int8_pool_matches_reference():
    """extend_quant (padding columns, two slots at their own offsets), then
    decode_step_quant (one slot inactive), through one page table: the int8
    codes and f32 scales of all four pools are bit-identical to the
    reference's and the outputs agree within rtol = atol = 1e-4. RoPE is off
    here so that the K/V rows are exact in both packages (its cos / sin may
    differ in the last bit); the model tests below run it."""
    d, n_heads, n_kv, hd, pt, n_pages = 64, 4, 2, 16, 8, 12
    rng = np.random.default_rng(3)
    params = _exact_attention_params(rng, d, n_heads, n_kv, hd)
    kw = dict(head_dim=hd, qkv_bias=True, rope=False)
    ja = j_attn.Attention(d, n_heads, n_kv, JModelContext(
        policy=j_fp32_policy(), mode=J_SERVE, compute_dtype=jnp.float32,
        use_pallas=False), **kw)
    ta = attn.Attention(d, n_heads, n_kv, ModelContext(
        policy=fp32_policy(), mode=SERVE, compute_dtype=torch.float32,
        device="cpu"), **kw)
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_numpy(params, "cpu")
    x = rng.integers(-8, 9, (2, 8, d)).astype(np.float32) / 8
    xd = rng.integers(-8, 9, (2, 1, d)).astype(np.float32) / 8
    lengths0 = np.asarray([0, 5], np.int32)
    n_new = np.asarray([8, 3], np.int32)
    positions = lengths0[:, None] + np.arange(8)[None, :]
    valid = np.arange(8)[None, :] < n_new[:, None]
    ptab = np.arange(n_pages, dtype=np.int32).reshape(2, 6)[:, ::-1].copy()
    active = np.asarray([True, False])

    jc = {"k": jnp.zeros((n_pages, pt, n_kv, hd), jnp.int8),
          "v": jnp.zeros((n_pages, pt, n_kv, hd), jnp.int8),
          "ks": jnp.zeros((n_pages, pt, n_kv), jnp.float32),
          "vs": jnp.zeros((n_pages, pt, n_kv), jnp.float32)}
    jy1, jc = ja.extend_quant(jp, jnp.asarray(x), jc, jnp.asarray(positions),
                              jnp.asarray(valid), page_table=jnp.asarray(ptab))
    jy2, jc = ja.decode_step_quant(jp, jnp.asarray(xd), jc,
                                   jnp.asarray(lengths0 + n_new),
                                   page_table=jnp.asarray(ptab),
                                   active=jnp.asarray(active))

    t = torch.from_numpy
    tc = {"k": torch.zeros((n_pages + 1, pt, n_kv, hd), dtype=torch.int8),
          "v": torch.zeros((n_pages + 1, pt, n_kv, hd), dtype=torch.int8),
          "ks": torch.zeros((n_pages + 1, pt, n_kv)),
          "vs": torch.zeros((n_pages + 1, pt, n_kv))}
    ty1, tc = ta.extend_quant(tp, t(x), tc, t(positions), t(valid), t(ptab))
    ty2, tc = ta.decode_step_quant(tp, t(xd), tc, t(lengths0 + n_new), t(ptab),
                                   active=t(active))
    for name in ("k", "v", "ks", "vs"):
        assert tc[name].dtype == (torch.int8 if len(name) == 1 else torch.float32)
        np.testing.assert_array_equal(tc[name][:n_pages].numpy(),
                                      np.asarray(jc[name]), err_msg=name)
    assert int((tc["k"] != 0).sum()) > 0
    np.testing.assert_allclose(ty1.numpy(), np.asarray(jy1), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ty2.numpy(), np.asarray(jy2), rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------
# model level: one extend, one decode step on a paged pool
# --------------------------------------------------------------------------
@pytest.mark.parametrize("path", ["float", "xnor", "int8"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_model_extend_and_decode_match_reference(arch, path):
    """Logits within rtol = atol = 1e-4; the pools agree: float K/V within
    the same tolerance, int8 codes within one step (the K/V rows come from
    f32 sums in another order, which can move a value across a rounding
    boundary) and scales within rtol 1e-4."""
    cfg, sm_j, sp_j = _j_serve(arch, 0, path)
    sm, sp = _t_serve(arch, sp_j, path)
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab, size=(2, 8)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab, size=(2, 1)).astype(np.int32)
    ptab = np.arange(12, dtype=np.int32).reshape(2, 6)
    n_new = np.asarray([7, 5], np.int32)

    caches_j = sm_j.init_caches(2, 48, jnp.float32, page_tokens=8, n_pages=12)
    le_j, caches_j, len_j = sm_j.extend(sp_j, jnp.asarray(tokens), caches_j,
                                        jnp.zeros((2,), jnp.int32),
                                        jnp.asarray(n_new),
                                        page_table=jnp.asarray(ptab))
    ld_j, caches_j, _ = sm_j.decode_step(sp_j, jnp.asarray(nxt), caches_j, len_j,
                                         page_table=jnp.asarray(ptab))
    t = torch.from_numpy
    caches = sm.init_caches(2, 48, torch.float32, page_tokens=8, n_pages=12)
    le, caches, lengths = sm.extend(sp, t(tokens).long(), caches,
                                    torch.zeros((2,), dtype=torch.int32),
                                    t(n_new), t(ptab))
    ld, caches, _ = sm.decode_step(sp, t(nxt).long(), caches, lengths, t(ptab))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(len_j))
    np.testing.assert_allclose(le.numpy(), np.asarray(le_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ld_j), rtol=1e-4, atol=1e-4)
    assert set(caches[0]) == set(caches_j[0])
    int8_kv = cfg.kv_dtype == "int8"
    assert set(caches[0]) == ({"k", "v", "ks", "vs"} if int8_kv else {"k", "v"})
    for name, pool_j in caches_j[0].items():
        got, want = caches[0][name][:, :12].numpy(), np.asarray(pool_j)
        if name in ("k", "v") and int8_kv:
            assert got.dtype == np.int8
            assert np.abs(got.astype(np.int32) - want).max() <= 1, name
        elif int8_kv:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=0, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=name)


# --------------------------------------------------------------------------
# the reference's int8 KV walls, ported
# --------------------------------------------------------------------------
def test_decode_parity_bf16_vs_int8_kv():
    """Greedy decode with the int8 KV cache emits the bf16 cache's tokens
    (tests/test_serve.py TestInt8KV), on the reference's weights, and the
    same tokens as the JAX model's int8 KV run."""
    outs = {}
    for kvd in ("bf16", "int8"):
        cfg, sm_j, sp_j = _j_serve("granite-8b", 0, kv_dtype=kvd)
        sm, sp = _t_serve("granite-8b", sp_j, kv_dtype=kvd)
        caches = sm.init_caches(1, 16, torch.float32, page_tokens=8, n_pages=2)
        ptab = torch.arange(2, dtype=torch.int32)[None]
        logits, caches, lengths = sm.extend(
            sp, torch.tensor([[1, 2, 3, 4]]), caches,
            torch.zeros((1,), dtype=torch.int32),
            torch.tensor([4], dtype=torch.int32), ptab)
        tok = logits.argmax(-1)[:, None]
        seq = []
        for _ in range(4):
            logits, caches, lengths = sm.decode_step(sp, tok, caches, lengths, ptab)
            tok = logits.argmax(-1)[:, None]
            seq.append(int(tok[0, 0]))
        outs[kvd] = seq
        if kvd == "int8":
            lj, cj, len_j = sm_j.prefill(
                sp_j, {"tokens": jnp.array([[1, 2, 3, 4]], jnp.int32)}, 16)
            tj, seq_j = jnp.argmax(lj, -1)[:, None].astype(jnp.int32), []
            for _ in range(4):
                lj, cj, len_j = sm_j.decode_step(sp_j, tj, cj, len_j)
                tj = jnp.argmax(lj, -1)[:, None].astype(jnp.int32)
                seq_j.append(int(tj[0, 0]))
            assert seq == seq_j
    assert outs["bf16"] == outs["int8"]


def _j_monolithic(sm_j, sp_j, prompt, n_tokens):
    """The reference's monolithic greedy tokens: one whole-prompt prefill,
    then stepwise decode (tests/test_chunked_prefill.py)."""
    zeros = jnp.zeros((1,), jnp.float32), jnp.zeros((1,), jnp.int32)
    key = jax.random.PRNGKey(0)[None]

    def greedy(logits):
        return int(j_sample_batch(logits, key, temperature=zeros[0],
                                  top_k=zeros[1])[0])

    logits, caches, lengths = sm_j.prefill(
        sp_j, {"tokens": jnp.asarray([prompt], jnp.int32)}, 64)
    out = [greedy(logits)]
    for _ in range(1, n_tokens):
        logits, caches, lengths = sm_j.decode_step(
            sp_j, jnp.array([[out[-1]]], jnp.int32), caches, lengths)
        out.append(greedy(logits))
    return out


@pytest.mark.parametrize("arch,over", [("granite-8b", {"kv_dtype": "int8"}),
                                       ("qwen1.5-32b", {})])
def test_int8_kv_parity_across_chunk_sizes(arch, over):
    """Under int8 KV the engine's greedy tokens are the reference's
    monolithic-prefill tokens for every chunk size: chunked extend quantizes
    each new row with the scales a whole-prompt prefill computes
    (tests/test_chunked_prefill.py)."""
    prompt = [3, 9, 4, 11, 7, 2, 5]
    cfg, sm_j, sp_j = _j_serve(arch, 0, **over)
    ref = _j_monolithic(sm_j, sp_j, prompt, 6)
    sm, sp = _t_serve(arch, sp_j, **over)
    for chunk in (3, 7, 16):
        eng = BatchedEngine(sm, sp, ServeConfig(n_slots=2, max_len=64,
                                                chunk_tokens=chunk))
        assert eng.caches[0]["k"].dtype == torch.int8
        r = eng.submit(prompt, SamplingParams(max_tokens=6))
        eng.run_until_drained()
        assert r.output == ref, (chunk, r.output, ref)


# --------------------------------------------------------------------------
# the streamed build_serving
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_streamed_build_equals_whole_tree_build(arch):
    """``build_serving`` builds, exports and frees one master leaf at a
    time; its params are ``torch.equal`` to exporting the whole tree of
    ``t_model.init(seed)``, leaf for leaf."""
    cfg = get_config(arch).reduced()
    _, sp, _ = serve_cli.build_serving(cfg, device="cpu", seed=4,
                                       compute_dtype=torch.float32)
    tm = build_model(cfg, ModelContext(policy=cfg.tbn, mode=TRAIN,
                                       compute_dtype=torch.float32, device="cpu"))
    sm = build_model(cfg, ModelContext(policy=cfg.tbn, mode=SERVE,
                                       compute_dtype=torch.float32, device="cpu"))
    want = export_serving_params(tm.specs(), sm.specs(), tm.init(4), cfg.tbn)
    got_leaves, want_leaves = dict(mod.walk(sp)), dict(mod.walk(want))
    assert got_leaves.keys() == want_leaves.keys()
    for path, leaf in want_leaves.items():
        assert got_leaves[path].dtype == leaf.dtype, path
        assert torch.equal(got_leaves[path], leaf), path


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_streamed_build_reports_the_whole_tree_master_bytes(arch):
    cfg = get_config(arch).reduced()
    _, _, master_b = serve_cli.build_serving(cfg, device="cpu", seed=0)
    tm = build_model(cfg, ModelContext(policy=cfg.tbn, mode=TRAIN, device="cpu"))
    assert master_b == serving_bytes(tm.init(0))


def test_lazy_params_read_like_the_built_tree():
    cfg = get_config("qwen1.5-32b").reduced()
    tm = build_model(cfg, ModelContext(policy=cfg.tbn, mode=TRAIN, device="cpu"))
    lazy = mod.LazyParams(tm.specs(), 2, "cpu")
    full = tm.init(2)
    assert lazy.get("nope", 7) == 7
    assert torch.equal(lazy["seg0"]["mixer"]["wq"]["b"],
                       full["seg0"]["mixer"]["wq"]["b"])
    assert torch.equal(lazy.get("head")["w"], full["head"]["w"])
    # every read builds afresh: nothing is kept
    assert lazy["head"]["w"] is not lazy["head"]["w"]


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_cli_serves_each_new_arch_on_cpu(arch, capsys):
    reqs = serve_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--requests", "3", "--max-tokens", "4",
                           "--max-len", "48"])
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke" in out
    assert all(r.done and len(r.output) == 4 for r in reqs)
