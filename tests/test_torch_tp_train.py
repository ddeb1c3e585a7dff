"""Training under a ("data", "model") mesh, on gloo ranks on the CPU, against
the JAX package's one-device train step on the same masters.

Two jobs of ``tests/torch_mesh_worker.py`` ranks, started together once for
the module: 2 ranks with the (1, 2) and (2, 1) meshes and 4 ranks with
(2, 2). Under a mesh a rank holds r/TP unique rows of every replica of a
tiled Dense's masters (starcoder2-7b, whose config sets ``fsdp_weights``,
also a block of n_in over "data"), takes its rows of the global batch,
and the step averages over "data":

* granite-8b ``.reduced()`` in f32, fused (B5 + B2 per shard, their plain
  versions here) and unfused: each rank's tile words of a probe layer equal
  the matching rows of the JAX package's ``tile_construct`` exactly, alpha
  within rtol 1e-6, the step-1 loss and clip norm within rtol 1e-5, every
  gradient leaf within 1e-4 * its max |g|, the step-2 loss within 1e-4;
* starcoder2-7b ``.reduced()`` under FSDP at (2, 1) and (2, 2), the same
  checks (its grad_accum of 2 splits each rank's rows as the reference
  splits the batch);
* each rank's master bytes against the reference's ``param_shardings``
  bytes per device;
* a checkpoint written under (2, 2) restored (``elastic_restore``) onto
  (1, 2) and onto one device equals the state the writers ended with;
* a fault on rank 1's data pipeline at step 3 restarts both ranks from
  the step-2 checkpoint, to the unfaulted run's final params, without a
  hang;
* the train CLI's ``--mesh 2x1`` under ``torch.distributed.run``.
"""
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import build_model as j_build_model
from repro.configs import get_config as j_get_config
from repro.core.tiling import plan_tiling as j_plan_tiling
from repro.kernels import ops as j_ops
from repro.nn import module as j_mod
from repro.nn.context import TRAIN as J_TRAIN
from repro.nn.context import ModelContext as JModelContext
from repro.optim import adamw as j_adamw
from repro.train.step import build_train_step as j_build_train_step
from repro.train.step import init_state as j_init_state
from repro_torch.configs import build_model, get_config
from repro_torch.distributed.sharding import param_specs, train_shards
from repro_torch.nn import module as mod
from repro_torch.nn.context import ModelContext
from repro_torch.nn.moe import MOE_TRAIN_TP_ITEM
from repro_torch.optim import adamw
from repro_torch.train.step import init_state
from torch_mesh_worker import finish_job, start_job

torch.set_num_threads(2)
GRANITE, STARCODER = "granite-8b", "starcoder2-7b"
LR = 1e-3
PROBE = "seg0/mixer/wk/w"           # r = 4 unique rows of 64 inputs, p = 8
TWO, FOUR = [(1, 2), (2, 1)], [(2, 2)]
ROOT = Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def _masters(arch):
    cfg = j_get_config(arch).reduced()
    tm = j_build_model(cfg, JModelContext(policy=cfg.tbn, mode=J_TRAIN,
                                          compute_dtype=jnp.float32))
    return jax.tree.map(np.asarray, j_mod.init_params(tm.specs(),
                                                      jax.random.PRNGKey(0)))


def _batches(arch):
    rng = np.random.default_rng(5)
    return [rng.integers(0, j_get_config(arch).reduced().vocab, (4, 16)
                         ).astype(np.int32) for _ in range(2)]


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The JAX one-device step: step-1 gradients (the microbatch mean), loss
    and clip norm, the step-2 loss, and the probe layer's tile words and
    alpha."""
    cfg = j_get_config(arch).reduced()
    tm = j_build_model(cfg, JModelContext(policy=cfg.tbn, mode=J_TRAIN,
                                          compute_dtype=jnp.float32))
    params = jax.tree.map(jnp.asarray, _masters(arch))
    grad_fn = jax.jit(jax.value_and_grad(tm.train_forward, has_aux=True))
    b0 = jnp.asarray(_batches(arch)[0])
    parts = [grad_fn(params, {"tokens": mb})[1]
             for mb in jnp.split(b0, cfg.grad_accum)]
    grads = jax.tree.map(lambda *g: np.asarray(sum(g) / len(g)), *parts)
    step = jax.jit(j_build_train_step(tm.train_forward, j_adamw(LR),
                                      grad_accum=cfg.grad_accum))
    state = j_init_state(params, j_adamw(LR))
    losses, norms = [], []
    for b in _batches(arch):
        state, m = step(state, {"tokens": jnp.asarray(b)})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    w0 = params
    for k in PROBE.split("/"):
        w0 = w0[k]
    spec = j_plan_tiling(w0.shape[1:], p=cfg.tbn.p, min_size=cfg.tbn.min_size,
                         alpha_mode=cfg.tbn.alpha_mode,
                         alpha_source=cfg.tbn.alpha_source, require_aligned=True)
    words, alpha = j_ops.tile_construct(w0[0], spec, use_pallas=False)
    return dict(grads=grads, losses=losses, norms=norms,
                words=np.asarray(words), alpha=np.asarray(alpha))


def _train_case(arch, fused, meshes):
    return dict(kind="train", arch=arch, fused=fused, dtype="float32",
                masters=_masters(arch), batches=_batches(arch), lr=LR,
                probe=PROBE, meshes=meshes)


@functools.lru_cache(maxsize=None)
def _jobs(tmp_root):
    """Both jobs and the CLI run, started together; their results."""
    root = Path(tmp_root)
    ckpt = root / "ckpt_2x2"
    ckpt.mkdir(parents=True)
    fault = dict(kind="fault", arch=GRANITE, fused=True, dtype="float32",
                 steps=5, fault_at=2, job_dir=str(root / "two"), meshes=[(1, 2)])
    two_cases = [_train_case(GRANITE, True, TWO), _train_case(GRANITE, False, TWO),
                 _train_case(STARCODER, True, [(2, 1)]), fault,
                 dict(kind="ckpt_restore", arch=GRANITE, fused=True,
                      dtype="float32", ckpt=str(ckpt), writers=4,
                      meshes=[(1, 2)])]
    four_cases = [dict(kind="ckpt_write", arch=GRANITE, fused=True,
                       dtype="float32", steps=3, ckpt=str(ckpt), meshes=FOUR),
                  _train_case(GRANITE, True, FOUR), _train_case(GRANITE, False, FOUR),
                  _train_case(STARCODER, False, FOUR)]
    two = start_job({"device": "cpu", "meshes": TWO, "cases": two_cases}, 2,
                    root / "two")
    four = start_job({"device": "cpu", "meshes": FOUR, "cases": four_cases}, 4,
                     root / "four")
    cli = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", "--reduced",
         "--device", "cpu", "--steps", "3", "--batch", "4", "--seq", "16",
         "--log-every", "1", "--mesh", "2x1", "--ckpt-dir", str(root / "cli")],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                           OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return {"two": (two_cases, finish_job(two, timeout=300)),
            "four": (four_cases, finish_job(four, timeout=300)),
            "cli": cli.communicate(timeout=300) + (cli.returncode,)}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    return _jobs(str(tmp_path_factory.mktemp("tp_train")))


def _results(jobs, kind, arch=None, fused=None):
    """(mesh, [rank results]) of every case of ``kind`` (and arch, fused)."""
    out = []
    for name in ("two", "four"):
        cases, ranks = jobs[name]
        for i, case in enumerate(cases):
            if case["kind"] != kind or arch and case["arch"] != arch:
                continue
            if fused is not None and case["fused"] != fused:
                continue
            for dims in case["meshes"]:
                out.append((tuple(dims), [r[(i, tuple(dims))] for r in ranks]))
    return out


def _check_train(got, ref, dims):
    r0 = got[0]
    for r in got[1:]:       # every rank holds the same step
        assert r["losses"] == r0["losses"] and r["norms"] == r0["norms"]
    np.testing.assert_allclose(r0["losses"][0], ref["losses"][0], rtol=1e-5)
    np.testing.assert_allclose(r0["norms"][0], ref["norms"][0], rtol=1e-5)
    np.testing.assert_allclose(r0["losses"][1], ref["losses"][1], rtol=1e-4)
    for path, g in mod.walk(r0["grads"]):
        g_ref = mod.get_path(ref["grads"], path)
        tol = 1e-4 * float(np.abs(g_ref).max())
        np.testing.assert_allclose(g.numpy(), g_ref, rtol=0, atol=tol,
                                   err_msg=f"{dims} {'/'.join(path)}")
    tp = dims[1]
    for r in got:
        n = ref["words"].size // tp
        t = r["model_index"]
        np.testing.assert_array_equal(r["words"].numpy(), ref["words"][t * n:(t + 1) * n])
        np.testing.assert_allclose(r["alpha"].numpy(), ref["alpha"], rtol=1e-6)


@pytest.mark.parametrize("fused", [True, False])
def test_granite_trains_under_each_mesh_as_on_one_device(jobs, fused):
    runs = _results(jobs, "train", GRANITE, fused)
    assert sorted(d for d, _ in runs) == [(1, 2), (2, 1), (2, 2)]
    for dims, got in runs:
        _check_train(got, _reference(GRANITE), dims)


def test_starcoder2_trains_under_fsdp(jobs):
    runs = _results(jobs, "train", STARCODER)
    assert sorted(d for d, _ in runs) == [(2, 1), (2, 2)]
    for dims, got in runs:
        _check_train(got, _reference(STARCODER), dims)


def _whole_bytes(arch):
    return sum(v.nbytes for _, v in mod.walk(_masters(arch)))


def test_master_bytes_a_rank_against_the_reference_per_device(jobs):
    """A rank keeps 1/TP of the tiled masters' rows (and 1/DP of their n_in
    under FSDP) and the rest whole; the reference's ``param_shardings``
    (``param_specs``, equal to it) 2D-shards every leaf, so it holds no
    more a device."""
    for arch in (GRANITE, STARCODER):
        cfg = get_config(arch).reduced()
        model = build_model(cfg, ModelContext(policy=cfg.tbn, device="cpu",
                                              compute_dtype=torch.float32))
        specs = model.specs()
        logical = mod.logical_axes(specs)
        shapes = mod.map_tree(lambda s: s.shape, specs)
        for dims, got in _results(jobs, "train", arch):
            mesh = {"data": dims[0], "model": dims[1]}
            shards = train_shards(specs, mesh, fsdp=cfg.fsdp_weights)
            want = 0
            for path, spec in mod.walk(specs):
                n = int(np.prod(spec.shape)) * 4
                shard = mod.get_path(shards, path)
                if shard is not None:
                    for a in shard.rows + shard.cols:
                        n //= mesh[a]
                want += n
            ref = 0
            for path, axes in mod.walk(param_specs(mesh, logical, shapes)):
                n = int(np.prod(mod.get_path(shapes, path))) * 4
                for ax in axes:
                    for a in (ax,) if isinstance(ax, str) else (ax or ()):
                        n //= mesh[a]
                ref += n
            for r in got:
                assert r["master_bytes"] == want, (arch, dims)
            split = dims[1] > 1 or cfg.fsdp_weights
            assert ref <= want < _whole_bytes(arch) or not split and (
                want == _whole_bytes(arch)), (
                f"{arch} {dims}: a rank holds {want} B of masters, the "
                f"reference {ref} B a device, one device {_whole_bytes(arch)} B")


def test_checkpoint_under_2x2_restores_onto_1x2_and_one_device(jobs):
    from repro_torch.ft.recovery import elastic_restore

    [(_, writers)] = _results(jobs, "ckpt_write")
    final = writers[0]["params"]
    assert writers[0]["step"] == 3
    [(_, readers)] = _results(jobs, "ckpt_restore")
    cfg = get_config(GRANITE).reduced()
    model = build_model(cfg, ModelContext(policy=cfg.tbn, device="cpu",
                                          compute_dtype=torch.float32))
    whole = sum(v.numel() for _, v in mod.walk(final))
    tiled = sum(int(np.prod(s.shape)) for _, s in mod.walk(model.specs()) if s.tile_p)
    for r in readers:
        assert r["step"] == 3 and r["held"] == whole - tiled // 2
        for path, v in mod.walk(final):
            np.testing.assert_array_equal(mod.get_path(r["params"], path).numpy(),
                                          v.numpy())
    root = Path(jobs["two"][0][-1]["ckpt"])
    template = init_state(model.init(0), adamw(LR))
    step, state = elastic_restore(root, template, None)
    assert step == 3 and state.opt_state.step == 3
    for path, v in mod.walk(final):
        np.testing.assert_array_equal(mod.get_path(state.params, path).numpy(),
                                      v.numpy())
    for path, v in mod.walk(readers[0]["mu"]):
        np.testing.assert_array_equal(mod.get_path(state.opt_state.mu, path).numpy(),
                                      v.numpy())


def test_fault_on_one_rank_restarts_every_rank(jobs):
    [(_, got)] = _results(jobs, "fault")
    for r in got:
        assert r["clean"]["restarts"] == 0 and r["faulted"]["restarts"] == 1
        assert r["faulted"]["step"] == r["clean"]["step"] == 5
        for path, v in mod.walk(r["clean"]["params"]):
            np.testing.assert_array_equal(
                mod.get_path(r["faulted"]["params"], path).numpy(), v.numpy())


def test_train_cli_mesh_under_torch_distributed_run(jobs):
    out, err, rc = jobs["cli"]
    assert rc == 0, err[-3000:]
    assert out.count("done: 3 steps") == 1          # the first rank alone
    assert "mesh=2x1 backend=gloo (2 ranks on the CPU)" in out


def test_moe_banks_under_a_model_axis_raise():
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    model = build_model(cfg, ModelContext(policy=cfg.tbn, device="cpu"))
    with pytest.raises(NotImplementedError, match="9e"):
        train_shards(model.specs(), {"data": 1, "model": 2})
    assert "9e" in MOE_TRAIN_TP_ITEM
    # replicated over "data" the banks (and every other leaf) stay whole
    assert not list(mod.walk(train_shards(model.specs(), {"data": 2, "model": 1})))


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", sorted(J_ARCH_IDS))
def test_config_fsdp_weights_matches_reference(arch, reduced):
    cj, ct = j_get_config(arch), get_config(arch)
    if reduced:
        cj, ct = cj.reduced(), ct.reduced()
    assert ct.fsdp_weights == cj.fsdp_weights
