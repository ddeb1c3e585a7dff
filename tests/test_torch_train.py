"""Port parity of the training slice against the JAX package, reduced
granite-8b, f32, the same numpy params and batches on both sides:
``DecoderLM.train_forward`` loss and every gradient leaf (fused and not),
the optimizers and ``build_train_step`` over three steps, checkpoints that
load in either direction, recovery that replays a failed run exactly, the
data generator and the training CLI on the CPU."""
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build_model as j_build_model
from repro.configs import get_config as j_get_config
from repro.ft import checkpoint as j_ckpt
from repro.nn import module as j_mod
from repro.nn.context import TRAIN as J_TRAIN
from repro.nn.context import ModelContext as JModelContext
from repro.optim import adamw as j_adamw
from repro.optim import clip_by_global_norm as j_clip
from repro.optim import cosine_with_warmup as j_cosine
from repro.optim import sgd_momentum as j_sgd
from repro.train.step import build_train_step as j_build_train_step
from repro.train.step import init_state as j_init_state
from repro_torch.configs import build_model, get_config
from repro_torch.data.pipeline import DataPipeline
from repro_torch.data.synthetic import lm_batch
from repro_torch.ft import checkpoint as ckpt
from repro_torch.ft.recovery import RecoveryManager
from repro_torch.launch import train as train_cli
from repro_torch.models import lm
from repro_torch.nn import module as mod
from repro_torch.nn.context import TRAIN, ModelContext
from repro_torch.optim import adamw, clip_by_global_norm, cosine_with_warmup, sgd_momentum
from repro_torch.serve.weights import params_from_numpy
from repro_torch.train.step import build_train_step, init_state

torch.set_num_threads(2)
RTOL = 1e-4


def _close(got, want, rtol=RTOL, **kw):
    """rtol with atol rtol * max|want| (f32 sums in another order)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()), **kw)


@functools.lru_cache(maxsize=None)
def _models(fused: bool):
    cfg_j = j_get_config("granite-8b").reduced()
    mj = j_build_model(cfg_j, JModelContext(policy=cfg_j.tbn, mode=J_TRAIN,
                                            compute_dtype=jnp.float32,
                                            fused_train=fused))
    cfg = get_config("granite-8b").reduced()
    mt = build_model(cfg, ModelContext(policy=cfg.tbn, mode=TRAIN,
                                       compute_dtype=torch.float32, device="cpu",
                                       fused_train=fused))
    return cfg, mj, mt


@functools.lru_cache(maxsize=None)
def _params_np():
    _, mj, _ = _models(False)
    return jax.tree.map(np.asarray, j_mod.init_params(mj.specs(), jax.random.PRNGKey(0)))


def _torch_params():
    return params_from_numpy(_params_np(), "cpu")


def _tokens(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _host(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _assert_trees_close(got_tree, want_tree, rtol, atol=None):
    for path, got in mod.walk(got_tree):
        want = np.asarray(_leaf(want_tree, path))
        np.testing.assert_allclose(
            _host(got), want, rtol=rtol, err_msg="/".join(path),
            atol=rtol * float(np.abs(want).max()) if atol is None else atol)


# --------------------------------------------------------------------------
# train_forward
# --------------------------------------------------------------------------
@pytest.mark.parametrize("fused,b,s", [(False, 2, 16), (True, 2, 16), (False, 1, 256)])
def test_train_forward_loss_and_grads_match_jax(fused, b, s):
    """S = 256 reaches the chunked attention path (reduced attn_chunk 64)."""
    cfg, mj, mt = _models(fused)
    toks = _tokens(b * s, b, s)
    (loss_j, aux_j), grads_j = jax.value_and_grad(mj.train_forward, has_aux=True)(
        jax.tree.map(jnp.asarray, _params_np()), {"tokens": jnp.asarray(toks)})
    params = _torch_params()
    paths, leaves = zip(*mod.walk(params))
    for v in leaves:
        v.requires_grad_()
    loss, aux = mt.train_forward(params, {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=RTOL)
    np.testing.assert_allclose(float(aux["ce"].detach()), float(aux_j["ce"]), rtol=RTOL)
    for path, g in zip(paths, grads):
        _close(g.numpy(), _leaf(grads_j, path), err_msg="/".join(path))


def test_train_forward_loss_mask_and_chunked_ce(monkeypatch):
    """A loss mask, and the batch-chunked CE branch (b = 64, threshold
    lowered) against the reference's unchunked sum."""
    cfg, mj, mt = _models(False)
    toks = _tokens(5, 64, 8)
    mask = (np.random.default_rng(6).random((64, 8)) < 0.7).astype(np.float32)
    batch_j = {"tokens": jnp.asarray(toks), "loss_mask": jnp.asarray(mask)}
    loss_j, _ = mj.train_forward(jax.tree.map(jnp.asarray, _params_np()), batch_j)
    monkeypatch.setattr(lm, "CE_CHUNK_MIN_ELEMS", 0)
    calls = []
    orig = mt._ce_sum_chunk
    monkeypatch.setattr(mt, "_ce_sum_chunk", lambda *a: calls.append(1) or orig(*a))
    loss, _ = mt.train_forward(_torch_params(), {
        "tokens": torch.from_numpy(toks), "loss_mask": torch.from_numpy(mask)})
    assert len(calls) == 2
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=RTOL)


# --------------------------------------------------------------------------
# optimizers and the train step
# --------------------------------------------------------------------------
def test_cosine_schedule_and_clip_match_jax():
    sj, st = j_cosine(1e-3, 3, 10, floor=1e-5), cosine_with_warmup(1e-3, 3, 10, floor=1e-5)
    for step in range(0, 13):
        np.testing.assert_allclose(st(step), float(sj(jnp.asarray(step))), rtol=1e-6)
    tree = {"a": np.float32([3.0, 4.0]), "b": {"c": np.float32([[12.0]])}}
    for max_norm in (1.0, 100.0):
        want, norm_j = j_clip(jax.tree.map(jnp.asarray, tree), max_norm)
        got, norm = clip_by_global_norm(params_from_numpy(tree, "cpu"), max_norm)
        np.testing.assert_allclose(float(norm), float(norm_j), rtol=1e-6)
        _assert_trees_close(got, want, 1e-6)


@pytest.mark.parametrize("opt_name", ["adamw", "sgd"])
def test_optimizer_update_matches_jax_on_equal_grads(opt_name):
    """Three updates from the same gradients (some far below AdamW's eps)
    on both sides: the update arithmetic alone."""
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((4, 8)).astype(np.float32),
              "b": {"c": rng.standard_normal((5,)).astype(np.float32)}}
    if opt_name == "adamw":
        opt_j, opt = (j_adamw(j_cosine(1e-3, 2, 6), weight_decay=0.1),
                      adamw(cosine_with_warmup(1e-3, 2, 6), weight_decay=0.1))
    else:
        opt_j, opt = (j_sgd(0.05, momentum=0.9, weight_decay=0.01),
                      sgd_momentum(0.05, momentum=0.9, weight_decay=0.01))
    pj, sj = jax.tree.map(jnp.asarray, params), None
    pt = params_from_numpy(params, "cpu")
    sj, st = opt_j.init(pj), opt.init(pt)
    for i in range(3):
        g = jax.tree.map(lambda v: (rng.standard_normal(v.shape) * 10.0 ** rng.integers(
            -12, 0, v.shape)).astype(np.float32), params)
        pj, sj = opt_j.update(jax.tree.map(jnp.asarray, g), sj, pj)
        pt, st = opt.update(params_from_numpy(g, "cpu"), st, pt)
    assert st.step == int(sj.step) == 3
    _assert_trees_close(pt, pj, 1e-6)


@pytest.mark.parametrize("opt_name", ["adamw", "sgd"])
@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_params_match_jax_after_three_steps(grad_accum, opt_name):
    """Losses and grad norms per step at rtol 1e-4; params after three
    steps at rtol 1e-5. The gradients of the two packages differ by f32
    summation order (~1e-5 of their largest entries). SGD is linear in
    them, so every param holds rtol 1e-5. AdamW moves each element by
    lr * m/(sqrt(v) + eps), which is +-lr for any gradient well above eps
    but follows the noise for the few whose gradient is near zero, so
    there 99.9% of the elements must hold rtol 1e-5 and every element
    the 2 * lr * steps that two updates can differ by at most (the update
    arithmetic itself is held on equal gradients above)."""
    _, mj, mt = _models(False)
    lr = 1e-3
    if opt_name == "adamw":
        opt_j = j_adamw(j_cosine(lr, 2, 6), weight_decay=0.1)
        opt = adamw(cosine_with_warmup(lr, 2, 6), weight_decay=0.1)
    else:
        opt_j = j_sgd(0.05, momentum=0.9, weight_decay=0.01)
        opt = sgd_momentum(0.05, momentum=0.9, weight_decay=0.01)
    step_j = jax.jit(j_build_train_step(mj.train_forward, opt_j, grad_accum=grad_accum))
    step = build_train_step(mt.train_forward, opt, grad_accum=grad_accum)
    state_j = j_init_state(jax.tree.map(jnp.asarray, _params_np()), opt_j)
    state = init_state(_torch_params(), opt)
    for i in range(3):
        toks = _tokens(100 + i, 4, 16)
        state_j, met_j = step_j(state_j, {"tokens": jnp.asarray(toks)})
        state, met = step(state, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(float(met["loss"]), float(met_j["loss"]), rtol=RTOL)
        np.testing.assert_allclose(float(met["grad_norm"]), float(met_j["grad_norm"]),
                                   rtol=RTOL)
    assert state.step == int(state_j.step) == 3
    assert state.opt_state.step == int(state_j.opt_state.step) == 3
    if opt_name == "sgd":
        _assert_trees_close(state.params, state_j.params, 1e-5)
        return
    n_off = n_all = 0
    for path, got in mod.walk(state.params):
        want = np.asarray(_leaf(state_j.params, path))
        d = np.abs(_host(got) - want)
        assert d.max() <= 2 * lr * 3, "/".join(path)
        n_off += int((d > 1e-5 * (np.abs(want) + np.abs(want).max())).sum())
        n_all += want.size
    assert n_off <= 1e-3 * n_all, (n_off, n_all)


def test_grad_accum_rejects_indivisible_batch():
    _, _, mt = _models(False)
    step = build_train_step(mt.train_forward, adamw(1e-3), grad_accum=3)
    with pytest.raises(ValueError, match="grad_accum=3"):
        step(init_state(_torch_params(), adamw(1e-3)),
             {"tokens": torch.from_numpy(_tokens(1, 4, 8))})


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _one_step_states():
    """(port state, JAX state) after one identical AdamW step (read only)."""
    _, mj, mt = _models(False)
    opt_j, opt = j_adamw(1e-3, weight_decay=0.1), adamw(1e-3, weight_decay=0.1)
    toks = _tokens(7, 2, 8)
    state_j, _ = jax.jit(j_build_train_step(mj.train_forward, opt_j))(
        j_init_state(jax.tree.map(jnp.asarray, _params_np()), opt_j),
        {"tokens": jnp.asarray(toks)})
    state, _ = build_train_step(mt.train_forward, opt)(
        init_state(_torch_params(), opt), {"tokens": torch.from_numpy(toks)})
    return state, state_j, opt, opt_j


def test_checkpoint_leaf_paths_match_jax(tmp_path):
    state, state_j, _, _ = _one_step_states()
    got = dict(ckpt.flatten_with_paths(state))
    want = dict(j_ckpt._flatten_with_paths(state_j))
    assert sorted(got) == sorted(want)
    assert "opt_state/mu/seg0/mixer/wq/w" in got and "step" in got


def test_port_checkpoint_restores_in_jax_and_back(tmp_path):
    state, state_j, opt, opt_j = _one_step_states()
    ckpt.save_checkpoint(tmp_path / "port", 1, state, metadata={"who": "port"})
    template_j = j_init_state(jax.tree.map(jnp.asarray, _params_np()), opt_j)
    step, restored_j = j_ckpt.restore_into(template_j, tmp_path / "port")
    assert step == 1 and int(restored_j.step) == 1 and int(restored_j.opt_state.step) == 1
    for (path, leaf), (_, want) in zip(j_ckpt._flatten_with_paths(restored_j),
                                       ckpt.flatten_with_paths(state)):
        np.testing.assert_array_equal(np.asarray(leaf), _host(want), err_msg=path)

    j_ckpt.save_checkpoint(tmp_path / "jax", 1, state_j)
    template = init_state(_torch_params(), opt)
    step, restored = ckpt.restore_into(template, tmp_path / "jax")
    assert step == 1 and restored.step == 1 and restored.opt_state.step == 1
    assert restored.params["embed"]["table"] is template.params["embed"]["table"]
    for (path, leaf), (_, want) in zip(ckpt.flatten_with_paths(restored),
                                       j_ckpt._flatten_with_paths(state_j)):
        np.testing.assert_array_equal(_host(leaf), np.asarray(want), err_msg=path)


def test_checkpoint_manager_async_retention_and_shape_check(tmp_path):
    state, _, opt, _ = _one_step_states()
    m = ckpt.CheckpointManager(tmp_path, save_every=2, max_to_keep=2)
    assert m.save(1, state) is None
    for s in (2, 4, 6):
        assert m.save(s, state) == s
    m.wait()
    assert ckpt.available_steps(tmp_path) == [4, 6] and m.latest_step() == 6
    bad = init_state(_torch_params(), opt)
    bad.params["embed"]["table"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="embed/table"):
        m.restore_into(bad)
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(tmp_path / "empty")


def test_async_checkpoint_is_a_snapshot_of_cpu_state(tmp_path, monkeypatch):
    """The writer thread is held until the state has been updated in place
    (as the optimizer does on the next step): the file must still hold the
    values of the step that was saved."""
    state, _, opt, _ = _one_step_states()
    want = {k: _host(v).copy() for k, v in ckpt.flatten_with_paths(state)}
    release, write = threading.Event(), ckpt._write

    def held_write(*args):
        assert release.wait(30)
        return write(*args)

    monkeypatch.setattr(ckpt, "_write", held_write)
    m = ckpt.CheckpointManager(tmp_path, save_every=1)
    assert m.save(1, state) == 1
    with torch.no_grad():
        for _, v in ckpt.flatten_with_paths(state):
            if isinstance(v, torch.Tensor):
                v.add_(1.0)
    release.set()
    m.wait()
    _, flat, _ = ckpt.restore_checkpoint(tmp_path, 1)
    assert sorted(flat) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)


# --------------------------------------------------------------------------
# recovery
# --------------------------------------------------------------------------
def _recovery_run(root, fail_at=None, steps=5):
    """Run ``steps`` steps; if ``fail_at``, the step that would produce
    global step ``fail_at`` raises once. -> (losses by step, manager, state)."""
    _, _, mt = _models(False)
    opt = adamw(cosine_with_warmup(1e-3, 2, steps), weight_decay=0.1)
    step_fn = build_train_step(mt.train_forward, opt)
    failed = []

    def flaky(state, batch):
        if state.step + 1 == fail_at and not failed:
            failed.append(state.step)
            raise RuntimeError("injected fault")
        return step_fn(state, batch)

    losses = {}
    rm = RecoveryManager(
        ckpt.CheckpointManager(root, save_every=2),
        make_state=lambda: init_state(_torch_params(), opt),
        make_data=lambda start: DataPipeline(
            lambda step: lm_batch(0, step, 2, 16, 512), start_step=start))
    final = rm.run(flaky, steps, hooks=lambda s, st, m: losses.__setitem__(
        s, float(m["loss"])))
    return losses, rm, final


def test_recovery_replays_the_uninterrupted_run_exactly(tmp_path):
    clean, rm0, final0 = _recovery_run(tmp_path / "clean")
    faulted, rm1, final1 = _recovery_run(tmp_path / "faulted", fail_at=4)
    assert rm0.restarts == 0 and rm1.restarts == 1
    assert faulted == clean and sorted(clean) == [1, 2, 3, 4, 5]
    assert final1.step == final0.step == 5
    for (path, a), (_, b) in zip(mod.walk(final0.params), mod.walk(final1.params)):
        assert torch.equal(a, b), path
    assert ckpt.latest_step(tmp_path / "faulted") == 5


def test_recovery_gives_up_after_max_restarts(tmp_path):
    def always(state, batch):
        raise RuntimeError("broken step")

    _, _, mt = _models(False)
    opt = adamw(1e-3)
    rm = RecoveryManager(
        ckpt.CheckpointManager(tmp_path, save_every=1), max_restarts=2,
        make_state=lambda: init_state(_torch_params(), opt),
        make_data=lambda start: DataPipeline(lambda s: lm_batch(0, s, 1, 4, 512),
                                             start_step=start))
    with pytest.raises(RuntimeError, match="broken step"):
        rm.run(always, 3)
    assert rm.restarts == 3


# --------------------------------------------------------------------------
# data and the CLI
# --------------------------------------------------------------------------
def test_lm_batch_is_a_pure_markov_stream():
    a = lm_batch(3, 7, 4, 64, 512)["tokens"]
    assert a.dtype == torch.int64 and a.shape == (4, 64)
    assert torch.equal(a, lm_batch(3, 7, 4, 64, 512)["tokens"])
    assert not torch.equal(a, lm_batch(3, 8, 4, 64, 512)["tokens"])
    assert not torch.equal(a, lm_batch(3, 7, 4, 64, 512, shard=1)["tokens"])
    follows = (a[:, 1:] == (a[:, :-1] * 17 + 7) % 512).float().mean()
    assert 0.85 < float(follows) < 0.97 and int(a.min()) >= 0 and int(a.max()) < 512


def test_pipeline_is_step_addressed_and_closes():
    p = DataPipeline(lambda s: {"s": s}, start_step=5, prefetch=2)
    assert [next(p)["s"] for _ in range(3)] == [5, 6, 7] and p.step == 8
    p.close()
    assert not p._thread.is_alive()

    def bad(step):
        raise KeyError("no data")

    q = DataPipeline(bad)
    with pytest.raises(KeyError, match="no data"):
        next(q)
    q.close()


def test_train_cli_on_cpu(tmp_path, capsys):
    final, history = train_cli.main(["--reduced", "--device", "cpu", "--steps", "5",
                                     "--batch", "2", "--seq", "16",
                                     "--ckpt-dir", str(tmp_path), "--log-every", "1"])
    out = capsys.readouterr().out
    assert "done: 5 steps" in out and "final step=5" in out
    assert [s for s, _ in history] == [1, 2, 3, 4, 5]
    assert np.isfinite([l for _, l in history]).all()
    assert ckpt.latest_step(tmp_path) == 5
    # resume: the run continues from the checkpoint to step 7
    final, history = train_cli.main(["--reduced", "--device", "cpu", "--steps", "7",
                                     "--batch", "2", "--seq", "16",
                                     "--ckpt-dir", str(tmp_path), "--log-every", "1"])
    assert [s for s, _ in history] == [6, 7] and final.step == 7


@pytest.mark.parametrize("mode", ["bwnn", "fp32"])
def test_train_cli_policy_modes(tmp_path, capsys, mode):
    train_cli.main(["--reduced", "--device", "cpu", "--steps", "2", "--batch", "2",
                    "--seq", "8", "--mode", mode, "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert f"mode={mode}" in out and "done: 2 steps" in out


def test_train_cli_mesh_not_ported(tmp_path, capsys):
    """``--mesh`` is ported (training under a mesh, run under
    ``torch.distributed.run``; ``tests/test_torch_tp_train.py``): 1x1 is one
    device, and a mesh the job's ranks do not fill exits naming the count."""
    train_cli.main(["--reduced", "--device", "cpu", "--mesh", "1x1", "--steps",
                    "2", "--batch", "2", "--seq", "8", "--ckpt-dir", str(tmp_path)])
    assert "done: 2 steps" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="needs 2 devices, have 1 ranks"):
        train_cli.main(["--reduced", "--device", "cpu", "--mesh", "2x1"])


def test_watchdog_flags_stragglers_and_hangs():
    from repro_torch.ft.watchdog import HeartbeatTable, StepWatchdog

    now = [0.0]
    wd = StepWatchdog(threshold=3.0, hang_timeout_s=10.0, clock=lambda: now[0])
    for dur in (1.0, 1.0, 1.0, 5.0):
        wd.start_step()
        now[0] += dur
        _, slow = wd.end_step()
    assert slow and wd.straggler_steps == [(3, 5.0, 1.0)] and wd.median == 1.0
    wd.start_step()
    now[0] += 11.0
    assert wd.check() == 11.0
    with pytest.raises(RuntimeError, match="start_step"):
        StepWatchdog().end_step()
    hb = HeartbeatTable(timeout_s=5.0, clock=lambda: now[0])
    hb.beat("a", at=0.0)
    hb.beat("b")
    assert hb.stragglers() == ["a"] and hb.hosts == ["a", "b"]
    hb.evict("a")
    assert hb.hosts == ["b"]
