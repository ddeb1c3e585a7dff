"""Port parity for the integer decode paths (``compute_path`` "xnor" and
"int8"): the quantizers, kernels B3/B4's plain versions, the dispatch in
``kernels.ops.tiled_dense_infer``, the model, the engine and the CLI.

The same numpy inputs go through the JAX package and the port. Integer
results (packed sign words, int8 codes, int32 accumulators, greedy tokens)
must be identical; the float scales differ at most by the order of an f32
``mean``. On the CPU the wrappers run their plain versions; the kernels
themselves are held against those on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build_model as j_build_model
from repro.configs import get_config as j_get_config
from repro.core.packing import pack_bits as j_pack_bits
from repro.core.tiling import plan_tiling as j_plan_tiling
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.kernels import tiled_xnor as j_x
from repro.kernels.tiled_matvec import sublane_rounded
from repro.nn import module as j_mod
from repro.nn.context import SERVE as J_SERVE
from repro.nn.context import TRAIN as J_TRAIN
from repro.nn.context import ModelContext as JModelContext
from repro.serve.engine import BatchedEngine as JBatchedEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.sampling import SamplingParams as JSamplingParams
from repro.serve.weights import export_serving_params as j_export
from repro_torch.configs import build_model, get_config
from repro_torch.core.tiling import plan_tiling
from repro_torch.kernels import ops, ref
from repro_torch.kernels import tiled_xnor as x8
from repro_torch.launch import serve as serve_cli
from repro_torch.nn import module as mod
from repro_torch.nn.context import SERVE, ModelContext
from repro_torch.serve.engine import BatchedEngine, ServeConfig
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.weights import params_from_numpy

torch.set_num_threads(2)
INT_PATHS = ("xnor", "int8")
# Same engine, prompts and master seed as tests/test_torch_engine.py
ENGINE = dict(n_slots=2, max_len=48, chunk_tokens=8, page_tokens=8)
PROMPT_LENS = (5, 11, 19)
# Outputs of the integer paths: the int32 accumulators are identical, the
# f32 scale mean|x| / amax/127 may differ in its last bits by sum order.
RTOL = 1e-5


def _rows(rng, r, n_in):
    t = np.where(rng.random((r, n_in)) < 0.5, 1.0, -1.0).astype(np.float32)
    return np.array(j_pack_bits(jnp.asarray(t)))


def _quantized(path, x, n_in):
    """(JAX quantized operand, port quantized operand) of numpy x."""
    jq = (j_x.quantize_sign if path == "xnor" else j_x.quantize_int8)(
        jnp.asarray(x), n_in)[0]
    tq = (x8.quantize_sign if path == "xnor" else x8.quantize_int8)(
        torch.from_numpy(x), n_in)[0]
    return jq, tq


def _pad(a, axis, mult):
    pad = (-a.shape[axis]) % mult
    if not pad:
        return a
    w = [(0, 0)] * a.ndim
    w[axis] = (0, pad)
    return jnp.pad(a, w)


def _pallas_acc(path, jq, rows, n_in):
    """The JAX Pallas kernel in interpret mode, padded as ``ops`` pads."""
    m, (r, words) = jq.shape[0], rows.shape
    if path == "xnor":
        bw, br = min(32, words), min(256, r)
        xq = _pad(_pad(jq, 0, sublane_rounded(m, jnp.int32)), 1, bw)
        tm = _pad(_pad(jnp.asarray(rows), 0, br), 1, bw)
        return j_x.tiled_xnor_matvec_unique(xq, tm, n_in=n_in, block_r=br,
                                            block_w=bw, interpret=True)[:m, :r]
    bk, br = min(1024, words * 32), min(256, r)
    q = jnp.pad(jq, ((0, 0), (0, words * 32 - n_in)))
    q = _pad(_pad(q, 0, sublane_rounded(m, jnp.int8)), 1, bk)
    tm = _pad(_pad(jnp.asarray(rows), 0, br), 1, bk // 32)
    return j_x.tiled_int8_matvec_unique(q, tm, r=tm.shape[0], block_r=br,
                                        block_k=bk, interpret=True)[:m, :r]


# --------------------------------------------------------------------------
# quantizers and popcount
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_in", [64, 80])
@pytest.mark.parametrize("m", [1, 4, 32])
def test_quantize_sign_matches_reference(m, n_in, dtype):
    rng = np.random.default_rng(m * 100 + n_in)
    x = rng.standard_normal((m, n_in + 16)).astype(np.float32)
    x[0, :5] = 0.0                       # zero is not > 0: bit 0
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jw, js = j_x.quantize_sign(jx, n_in)
    tw, ts = x8.quantize_sign(tx, n_in)
    assert tw.dtype == torch.int32 and tw.shape == (m, (n_in + 31) // 32)
    assert ts.dtype == torch.float32 and ts.shape == (m, 1)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_in", [64, 80])
@pytest.mark.parametrize("m", [1, 4, 32])
def test_quantize_int8_matches_reference(m, n_in, dtype):
    rng = np.random.default_rng(m * 10 + n_in)
    x = (3 * rng.standard_normal((m, n_in))).astype(np.float32)
    if m > 1:
        x[1] = 0.0                       # all-zero row: scale 1, q 0
    # amax 127 gives scale 1, so these land exactly on halves: half to even
    x[0, :6] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5]
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = j_x.quantize_int8(jx, n_in)
    tq, ts = x8.quantize_int8(tx, n_in)
    assert tq.dtype == torch.int8 and tq.shape == (m, n_in)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tq[0, :6].numpy(), [127, 2, -4, 0, 0, 2])


def test_popcount32_matches_independent_count():
    rng = np.random.default_rng(0)
    v = rng.integers(-2**31, 2**31, size=(64, 17), dtype=np.int64).astype(np.int32)
    v[0, :4] = [0, -1, -2**31, 2**31 - 1]
    want = np.vectorize(lambda w: bin(int(w) & 0xFFFFFFFF).count("1"))(v)
    got = x8.popcount32(torch.from_numpy(v))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_x.popcount32(
        jnp.asarray(v))))


# --------------------------------------------------------------------------
# plain B3 / B4: accumulators exactly equal to every JAX form
# --------------------------------------------------------------------------
@pytest.mark.parametrize("path", INT_PATHS)
@pytest.mark.parametrize("n_in,r", [(64, 8), (64, 24), (80, 8), (80, 24)])
@pytest.mark.parametrize("m", [1, 4, 32])
def test_plain_accumulators_match_reference_exactly(path, n_in, r, m):
    rng = np.random.default_rng(m * 1000 + n_in * 10 + r)
    x = rng.standard_normal((m, n_in)).astype(np.float32)
    rows = _rows(rng, r, n_in)
    jq, tq = _quantized(path, x, n_in)
    trows = torch.from_numpy(rows)
    if path == "xnor":
        want = np.asarray(j_ref.tiled_xnor_matvec_ref(jq, jnp.asarray(rows),
                                                      n_in=n_in))
        twin = j_x.xnor_matvec_words(jq, jnp.asarray(rows), n_in=n_in)
        plain = x8.xnor_matvec_words(tq, trows, n_in=n_in)
        wrapper = x8.tiled_xnor_matvec_unique(tq, trows, n_in=n_in)
        oracle = ref.tiled_xnor_matvec_ref(tq, trows, n_in=n_in)
    else:
        want = np.asarray(j_ref.tiled_int8_matvec_ref(jq, jnp.asarray(rows),
                                                      n_in=n_in))
        twin = j_x.int8_matvec_packed(jq, jnp.asarray(rows), n_in=n_in)
        plain = x8.int8_matvec_packed(tq, trows, n_in=n_in)
        qp = torch.nn.functional.pad(tq, (0, rows.shape[1] * 32 - n_in))
        wrapper = x8.tiled_int8_matvec_unique(qp, trows)
        oracle = ref.tiled_int8_matvec_ref(tq, trows, n_in=n_in)
    assert want.dtype == np.int32 and want.shape == (m, r)
    for got in (plain, wrapper, oracle):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(np.asarray(twin), want)
    np.testing.assert_array_equal(np.asarray(_pallas_acc(path, jq, rows, n_in)),
                                  want)


# --------------------------------------------------------------------------
# tiled_dense_infer under the integer paths
# --------------------------------------------------------------------------
def _dense_case(seed, m, n_in, r, alpha_mode, p=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, n_in)).astype(np.float32)
    t = np.where(rng.random((r, n_in)) < 0.5, 1.0, -1.0).astype(np.float32)
    kw = dict(p=p, min_size=1, alpha_mode=alpha_mode, alpha_source="W")
    spec_t = plan_tiling((p * r, n_in), **kw)
    alpha = rng.uniform(0.1, 1.1, spec_t.n_alpha).astype(np.float32)
    return (x, np.array(j_pack_bits(jnp.asarray(t))),
            np.array(j_pack_bits(jnp.asarray(t.reshape(-1)))), alpha,
            j_plan_tiling((p * r, n_in), **kw), spec_t)


@pytest.mark.parametrize("path", INT_PATHS)
@pytest.mark.parametrize("alpha_mode", ["layer", "tile"])
@pytest.mark.parametrize("n_in", [64, 80])
@pytest.mark.parametrize("m", [1, 4, 32, 33])
def test_tiled_dense_infer_int_paths_match_reference(m, n_in, alpha_mode, path):
    """m <= 32 quantizes and accumulates integers; m = 33 keeps the float
    path, as the reference does."""
    x, rows, _, alpha, spec_j, spec_t = _dense_case(7 * m + n_in, m, n_in, 24,
                                                    alpha_mode)
    want = np.asarray(j_ops.tiled_dense_infer(
        jnp.asarray(x), jnp.asarray(rows), jnp.asarray(alpha), spec_j,
        use_pallas=True, compute_path=path))
    got = ops.tiled_dense_infer(torch.from_numpy(x), torch.from_numpy(rows),
                                torch.from_numpy(alpha), spec_t,
                                compute_path=path)
    assert got.shape == (m, spec_t.shape[0]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)
    flt = ops.tiled_dense_infer(torch.from_numpy(x), torch.from_numpy(rows),
                                torch.from_numpy(alpha), spec_t)
    if m > 32:
        np.testing.assert_array_equal(got.numpy(), flt.numpy())
    else:
        assert not np.array_equal(got.numpy(), flt.numpy())


@pytest.mark.parametrize("path", INT_PATHS)
def test_flat_tile_on_cpu_takes_float_reference(path):
    """The reference's flat-tile rule: without the kernels (JAX
    ``use_pallas=False``, the port's CPU tensors) a flat tile takes the
    dense float reference whatever the compute path."""
    x, _, flat, alpha, spec_j, spec_t = _dense_case(3, 4, 64, 8, "tile")
    want = np.asarray(j_ops.tiled_dense_infer(
        jnp.asarray(x), jnp.asarray(flat), jnp.asarray(alpha), spec_j,
        use_pallas=False, compute_path=path))
    got = ops.tiled_dense_infer(torch.from_numpy(x), torch.from_numpy(flat),
                                torch.from_numpy(alpha), spec_t,
                                compute_path=path)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("path", INT_PATHS)
def test_int_path_refuses_devices_without_a_kernel(path):
    """Only a CPU tensor takes the plain version: the integer path's
    operator (B3 / B4) has a CUDA implementation (the launch), a CPU one
    and a fake one (on meta the layer gives its output's shape with no
    launch); a tensor on any other device finds no implementation."""
    spec = plan_tiling((4 * 8, 64), p=4, min_size=1, alpha_source="W")
    fn = (ops.tiled_xnor_matvec_unique if path == "xnor"
          else ops.tiled_int8_matvec_unique)
    before = fn.launches
    y = ops.tiled_dense_infer(torch.randn((4, 64), device="meta"),
                              torch.empty((8, 2), dtype=torch.int32,
                                          device="meta"),
                              torch.ones((4,), device="meta"), spec,
                              compute_path=path)
    assert (y.device.type, tuple(y.shape)) == ("meta", (4, 32))
    assert fn.launches == before
    for key, has in (("CPU", True), ("CUDA", True), ("Meta", True),
                     ("XPU", False), ("MPS", False), ("PrivateUse1", False)):
        assert torch._C._dispatch_has_kernel_for_dispatch_key(
            f"repro_torch::{fn.__name__}", key) == has, key


def test_wrappers_check_operands():
    w = torch.zeros((4, 2), dtype=torch.int32)
    packed = torch.zeros((8, 2), dtype=torch.int32)
    q = torch.zeros((4, 64), dtype=torch.int8)
    assert x8.tiled_xnor_matvec_unique(w, packed, n_in=64).shape == (4, 8)
    assert x8.tiled_int8_matvec_unique(q, packed).shape == (4, 8)
    with pytest.raises(TypeError):
        x8.tiled_xnor_matvec_unique(w.long(), packed, n_in=64)
    with pytest.raises(TypeError):
        x8.tiled_int8_matvec_unique(q.int(), packed)
    with pytest.raises(ValueError):
        x8.tiled_xnor_matvec_unique(torch.zeros((4, 3), dtype=torch.int32),
                                    packed, n_in=64)
    with pytest.raises(ValueError):
        x8.tiled_xnor_matvec_unique(w, packed, n_in=65)
    with pytest.raises(ValueError):
        x8.tiled_int8_matvec_unique(torch.zeros((4, 80), dtype=torch.int8),
                                    packed)
    with pytest.raises(ValueError, match="MATVEC_MAX_M"):
        x8.tiled_int8_matvec_unique(torch.zeros((33, 64), dtype=torch.int8),
                                    packed)
    with pytest.raises(ValueError):
        x8.tiled_int8_matvec_unique(torch.zeros((64, 4), dtype=torch.int8).T,
                                    packed)


# --------------------------------------------------------------------------
# model, engine and CLI on the reduced config (f32)
# --------------------------------------------------------------------------
def _j_models(path, seed):
    cfg = j_get_config("granite-8b").reduced()
    tm = j_build_model(cfg, JModelContext(policy=cfg.tbn, mode=J_TRAIN,
                                          compute_dtype=jnp.float32))
    sm = j_build_model(cfg, JModelContext(policy=cfg.tbn, mode=J_SERVE,
                                          compute_dtype=jnp.float32,
                                          use_pallas=False, compute_path=path))
    masters = j_mod.init_params(tm.specs(), jax.random.PRNGKey(seed))
    return cfg, sm, j_export(tm.specs(), sm.specs(), masters, cfg.tbn)


def _t_model(path, sp_j):
    cfg = get_config("granite-8b").reduced()
    sm = build_model(cfg, ModelContext(policy=cfg.tbn, mode=SERVE,
                                       compute_dtype=torch.float32,
                                       device="cpu", compute_path=path))
    return sm, params_from_numpy(jax.tree.map(np.asarray, sp_j), "cpu")


@pytest.mark.parametrize("path", INT_PATHS)
def test_decode_step_logits_match_reference(path):
    """One extend (2 x 8 = 16 rows, so the integer path too) then one
    decode step on a paged pool, logits against the JAX model's."""
    cfg, sm_j, sp_j = _j_models(path, 0)
    sm, sp = _t_model(path, sp_j)
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
    ld_j, _, _ = sm_j.decode_step(sp_j, jnp.asarray(nxt), caches_j, len_j,
                                  page_table=jnp.asarray(ptab))
    t = torch.from_numpy
    caches = sm.init_caches(2, 48, torch.float32, page_tokens=8, n_pages=12)
    le, caches, lengths = sm.extend(sp, t(tokens).long(), caches,
                                    torch.zeros((2,), dtype=torch.int32),
                                    t(n_new), t(ptab))
    ld, _, _ = sm.decode_step(sp, t(nxt).long(), caches, lengths, t(ptab))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(len_j))
    np.testing.assert_allclose(le.numpy(), np.asarray(le_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ld_j), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("path", INT_PATHS)
def test_greedy_tokens_identical_to_reference_engine(path):
    cfg_j, sm_j, sp_j = _j_models(path, 1)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg_j.vocab, size=n).astype(np.int32)
               for n in PROMPT_LENS]
    eng_j = JBatchedEngine(sm_j, sp_j, JServeConfig(
        **ENGINE, prefix_cache=False, telemetry=False, compute_path=path))
    reqs_j = [eng_j.submit(p, JSamplingParams(max_tokens=4)) for p in prompts]
    ticks_j = eng_j.run_until_drained()

    sm, sp = _t_model(path, sp_j)
    eng = BatchedEngine(sm, sp, ServeConfig(**ENGINE, compute_path=path))
    reqs = [eng.submit(p, SamplingParams(max_tokens=4)) for p in prompts]
    ticks = eng.run_until_drained()
    assert ticks == ticks_j
    for r, rj in zip(reqs, reqs_j):
        assert r.output == rj.output
        assert r.token_steps == rj.token_steps
    st, st_j = eng.stats(), eng_j.stats()
    assert st["compute_path"] == st_j["compute_path"] == path
    assert st["decode_ticks"] > 0 and st["extend_ticks"] > 0


def test_serve_config_validates_compute_path():
    with pytest.raises(ValueError, match="compute_path"):
        ServeConfig(**ENGINE, compute_path="fp8")
    cfg = get_config("granite-8b").reduced()
    sm = build_model(cfg, ModelContext(policy=cfg.tbn, mode=SERVE,
                                       compute_dtype=torch.float32,
                                       device="cpu", compute_path="xnor"))
    sp = mod.init_params(sm.specs(), 0, "cpu")
    with pytest.raises(ValueError, match="compute_path"):
        BatchedEngine(sm, sp, ServeConfig(**ENGINE))
    eng = BatchedEngine(sm, sp, ServeConfig(**ENGINE, compute_path="xnor"))
    assert eng.stats()["compute_path"] == "xnor"


@pytest.mark.parametrize("path", INT_PATHS)
def test_cli_serves_integer_path_on_cpu(path, capsys):
    reqs = serve_cli.main(["--reduced", "--device", "cpu", "--compute-path",
                           path, "--requests", "2", "--max-tokens", "3",
                           "--max-len", "32"])
    out = capsys.readouterr().out
    assert f"compute path: {path}" in out and "tok/s on CPU" in out
    assert all(len(r.output) == 3 for r in reqs)
    assert all(0 <= t < 512 for r in reqs for t in r.output)
