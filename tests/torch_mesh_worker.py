"""One rank of the port's mesh tests (``test_torch_tp_serve.py``,
``test_torch_tp_cuda.py``, ``test_torch_tp_train.py``,
``test_torch_compression.py``, ``test_torch_pipeline.py``,
``test_torch_tp_train_cuda.py``): joins a gloo job through a ``FileStore`` in the
job directory, builds the job's ("data", "model") meshes, runs the job's
cases under each and saves what it computed to ``rank<i>.pt`` there; the
test compares it with the JAX package and the port on one device.

    RANK=i WORLD_SIZE=n python tests/torch_mesh_worker.py JOB_DIR

``JOB_DIR/job.pt`` holds {"device", "meshes": [(dp, tp), ...], "cases":
[dict(kind=..., ...)]}; inputs are numpy arrays and param trees of them.
It imports torch and repro_torch only.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import build_model, get_config  # noqa: E402
from repro_torch.core.tiling import TileSpec  # noqa: E402
from repro_torch.distributed.sharding import axis_rules, place_params  # noqa: E402
from repro_torch.kernels.ops import tiled_conv_infer, tiled_dense_infer  # noqa: E402
from repro_torch.launch.mesh import MESH_DIMS, make_host_mesh  # noqa: E402
from repro_torch.nn.context import SERVE, ModelContext  # noqa: E402
from repro_torch.serve.engine import BatchedEngine, ServeConfig  # noqa: E402
from repro_torch.serve.sampling import SamplingParams  # noqa: E402
from repro_torch.serve.server import EngineServer  # noqa: E402
from repro_torch.serve.weights import (  # noqa: E402
    params_from_numpy,
    per_device_tile_bytes,
)


def _mesh(dims, device):
    if device.type == "cpu":
        return make_host_mesh(*dims)
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device.type, tuple(dims), mesh_dim_names=MESH_DIMS)


def _counters():
    from repro_torch.kernels.tiled_conv import tiled_conv_unique
    from repro_torch.kernels.tiled_matmul import tiled_matmul_unique
    from repro_torch.kernels.tiled_matvec import tiled_matvec_unique
    from repro_torch.kernels.tiled_xnor import (
        tiled_int8_matvec_unique,
        tiled_xnor_matvec_unique,
    )

    return {"B1": tiled_matvec_unique, "B2": tiled_matmul_unique,
            "B3": tiled_xnor_matvec_unique, "B4": tiled_int8_matvec_unique,
            "B6": tiled_conv_unique}


def _dense(case, mesh, dev):
    spec = TileSpec(**case["spec"])
    tree = {"tile": torch.from_numpy(case["rows"]).to(dev),
            "alpha": torch.from_numpy(case["alpha"]).to(dev)}
    placed = place_params(tree, {"tile": ("tile_rows", None), "alpha": (None,)},
                          mesh)
    out = {"rows_held": int(placed["tile"].shape[0])}
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    with axis_rules(mesh):
        for path in case["paths"]:
            for m, x in case["xs"].items():
                y = tiled_dense_infer(torch.from_numpy(x).to(dev), placed["tile"],
                                      placed["alpha"], spec, compute_path=path)
                out[f"{path}/{m}"] = y.cpu()
    out["launches"] = {k: fn.launches for k, fn in counters.items()}
    return out


def _conv(case, mesh, dev):
    spec = TileSpec(**case["spec"])
    tree = {"tile_conv": torch.from_numpy(case["packed"]).to(dev),
            "alpha": torch.from_numpy(case["alpha"]).to(dev)}
    placed = place_params(tree, {"tile_conv": (None, "tile_rows", None),
                                 "alpha": (None,)}, mesh)
    with axis_rules(mesh):
        y = tiled_conv_infer(torch.from_numpy(case["x"]).to(dev),
                             placed["tile_conv"], placed["alpha"], spec,
                             stride=tuple(case["stride"]), padding=case["padding"])
    return {"y": y.cpu(), "filters_held": int(placed["tile_conv"].shape[1])}


def _model(case, dev):
    cfg = get_config(case["arch"]).reduced()
    sm = build_model(cfg, ModelContext(
        policy=cfg.tbn, mode=SERVE, compute_dtype=getattr(torch, case["dtype"]),
        device=dev, compute_path=case.get("path", "float")))
    return cfg, sm, params_from_numpy(case["sp"], dev)


def _logits(case, mesh, dev):
    """Prefill of one prompt, then greedy decode steps, under the mesh."""
    _, sm, sp = _model(case, dev)
    rules = case.get("rules")
    placed = place_params(sp, sm.logical(), mesh, rules)
    tokens = torch.tensor([case["prompt"]], device=dev)
    out = {"logits": []}
    with torch.no_grad(), axis_rules(mesh, rules):
        lg, caches, lens = sm.prefill(placed, {"tokens": tokens}, case["max_len"])
        out["logits"].append(lg.cpu())
        for _ in range(case["decode_steps"]):
            tok = lg.argmax(-1)[:, None]
            lg, caches, lens = sm.decode_step(placed, tok, caches, lens)
            out["logits"].append(lg.cpu())
    out["tile_bytes"] = per_device_tile_bytes(placed, mesh)
    return out


def _engine(case, mesh, dev):
    _, sm, sp = _model(case, dev)
    eng = BatchedEngine(sm, sp, ServeConfig(**case["engine"]), mesh=mesh)
    reqs = [eng.submit(np.asarray(p, np.int32), SamplingParams(**kw))
            for p, kw in zip(case["prompts"], case["sampling"])]
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    ticks = eng.run_until_drained()
    refused = {}
    for what, start in (("warmup", eng.warmup), ("server", lambda: EngineServer(eng))):
        try:
            start()
        except NotImplementedError as e:
            refused[what] = str(e)
    return {"tokens": [r.output for r in reqs], "steps": [r.token_steps for r in reqs],
            "ticks": ticks, "refused": refused,
            "launches": {k: fn.launches for k, fn in counters.items()}}


# ---------------------------------------------------------------------------
# training under a mesh (test_torch_tp_train.py, test_torch_compression.py,
# test_torch_pipeline.py, test_torch_tp_train_cuda.py)
# ---------------------------------------------------------------------------
def _train_model(case, dev):
    import dataclasses

    cfg = dataclasses.replace(get_config(case["arch"]).reduced(),
                              remat=case.get("remat", "full"))
    ctx = ModelContext(policy=cfg.tbn, compute_dtype=getattr(torch, case["dtype"]),
                       device=dev, fused_train=case["fused"],
                       fsdp_weights=cfg.fsdp_weights)
    return cfg, build_model(cfg, ctx)


def _train(case, mesh, dev):
    """Two steps of the train step under the mesh from the case's masters:
    the losses and grad norms, step 1's gradients gathered whole, the probe leaf's tile words and whole alpha as this
    rank builds them, its master bytes and its kernel launches."""
    from repro_torch.distributed.sharding import (
        gather_train_params, place_train_params, sum_over, train_shards)
    from repro_torch.kernels.ops import _rows_spec, tile_construct
    from repro_torch.kernels.tile_construct import tile_construct_kernel
    from repro_torch.nn import module as mod
    from repro_torch.optim import adamw, sgd_momentum
    from repro_torch.train.step import build_train_step, init_state

    cfg, model = _train_model(case, dev)
    shards = train_shards(model.specs(), mesh, fsdp=cfg.fsdp_weights)
    params = place_train_params(params_from_numpy(case["masters"], dev), shards, mesh)
    opt = (sgd_momentum(case["lr"]) if case.get("opt") == "sgd"
           else adamw(case["lr"]))
    seen = {}

    def capture(grads):
        if "grads" not in seen:
            whole = gather_train_params(mod.map_tree(torch.clone, grads), shards, mesh)
            seen["grads"] = mod.map_tree(lambda g: g.cpu(), whole)
        return grads

    step = build_train_step(model.train_forward, opt, grad_accum=cfg.grad_accum,
                            mesh=mesh, shards=shards, grad_transform=capture)
    counters = dict(_counters(), B5=tile_construct_kernel)
    for fn in counters.values():
        fn.launches = 0
    state, losses, norms = init_state(params, opt), [], []
    probe = tuple(case["probe"].split("/"))
    w0 = mod.get_path(params, probe)[0].detach().clone()
    for tokens in case["batches"]:
        state, m = step(state, {"tokens": torch.from_numpy(tokens).to(dev)})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    launches = {k: fn.launches for k, fn in counters.items()}
    n_out, n_in = mod.get_path(case["masters"], probe).shape[-2:]
    spec = model.ctx.policy.spec_for((n_out, n_in), kind="dense")
    shard = mod.get_path(shards, probe)
    rows = () if shard is None else shard.rows
    if shard is not None and shard.cols:
        from repro_torch.distributed.sharding import gather_blocks
        w0 = gather_blocks(w0, mesh, shard.cols, -1)
    words, alpha = tile_construct(w0, _rows_spec(spec, w0))
    tp = 1
    for a in rows:
        tp *= mesh.size(mesh.mesh_dim_names.index(a))
    alpha = sum_over(alpha, mesh, rows) / tp
    return {"losses": losses, "norms": norms, "grads": seen["grads"],
            "words": words.cpu(), "alpha": alpha.cpu(),
            "model_index": mesh.get_local_rank("model"),
            "master_bytes": sum(v.numel() * v.element_size()
                                for _, v in mod.walk(state.params)),
            "launches": launches}


def _training(case, mesh, dev, ckpt_dir, fault_at=None):
    """The train CLI's wiring (``launch.train.build_training``) under the
    mesh, run to ``case["steps"]``; ``fault_at`` makes rank 1's data
    pipeline raise once when it fetches that step's batch."""
    from repro_torch.distributed.sharding import gather_train_params
    from repro_torch.launch.train import build_training
    from repro_torch.nn import module as mod

    cfg, _ = _train_model(case, dev)
    tr = build_training(cfg, _train_model(case, dev)[1].ctx, seed=0, batch=4,
                        seq=16, lr=1e-3, warmup=1, total_steps=case["steps"],
                        grad_accum=cfg.grad_accum, ckpt_dir=ckpt_dir,
                        ckpt_every=2, mesh=mesh)
    if fault_at is not None and dist.get_rank() == 1:
        make_data, fired = tr.recovery.make_data, []

        def faulty(start):
            it = iter(make_data(start))

            def gen():
                for i, batch in enumerate(it, start):
                    if i == fault_at and not fired:
                        fired.append(i)
                        raise RuntimeError(f"injected fault at step {i}")
                    yield batch
            return gen()

        tr.recovery.make_data = faulty
    final = tr.recovery.run(tr.step_fn, case["steps"])
    whole = gather_train_params(final.params, tr.shardings.shards, mesh)
    return {"params": mod.map_tree(lambda v: v.detach().cpu(), whole),
            "step": final.step, "restarts": tr.recovery.restarts}


def _fault(case, mesh, dev):
    job_dir = Path(case["job_dir"])
    clean = _training(case, mesh, dev, job_dir / f"clean_{mesh.shape}")
    faulted = _training(case, mesh, dev, job_dir / f"fault_{mesh.shape}",
                        fault_at=case["fault_at"])
    return {"clean": clean, "faulted": faulted}


def _ckpt_write(case, mesh, dev):
    """Train under the mesh with checkpoints in ``case["ckpt"]``; the state
    it ends with, gathered whole."""
    out = _training(case, mesh, dev, case["ckpt"])
    (Path(case["ckpt"]) / f"done_{dist.get_rank()}").write_text("1")
    return out


def _ckpt_restore(case, mesh, dev):
    """``elastic_restore`` of the checkpoint another job wrote under its
    mesh onto this job's mesh: each rank's blocks, gathered whole again."""
    import time

    from repro_torch.distributed.sharding import (
        TrainShardings, gather_train_params, train_shards)
    from repro_torch.ft.recovery import elastic_restore
    from repro_torch.nn import module as mod
    from repro_torch.optim import adamw
    from repro_torch.train.step import init_state

    root = Path(case["ckpt"])
    deadline = time.time() + 90
    while len(list(root.glob("done_*"))) < case["writers"]:
        if time.time() > deadline:
            raise TimeoutError(f"no checkpoint in {root}")
        time.sleep(0.2)
    cfg, model = _train_model(case, dev)
    template = init_state(model.init(0), adamw(1e-3))
    shards = train_shards(model.specs(), mesh, fsdp=cfg.fsdp_weights)
    step, state = elastic_restore(root, template, TrainShardings(mesh, shards))
    held = sum(v.numel() for _, v in mod.walk(state.params))
    whole = gather_train_params(state.params, shards, mesh)
    mu = gather_train_params(state.opt_state.mu, shards, mesh)
    return {"step": step, "held": held,
            "params": mod.map_tree(lambda v: v.cpu(), whole),
            "mu": mod.map_tree(lambda v: v.cpu(), mu)}


def _dp(case, mesh, dev):
    """``compressed_psum_mean`` of this rank's gradient tree under each
    codec, and (on CPU jobs) the reference test's least-squares problem
    trained by ``build_dp_train_step``."""
    from repro_torch.distributed.compression import (
        CompressionState, build_dp_train_step, compressed_psum_mean)
    from repro_torch.optim import constant, sgd_momentum
    from repro_torch.train.step import init_state

    rank = mesh.get_local_rank("data")
    grads = {k: torch.from_numpy(v[rank]).to(dev) for k, v in case["grads"].items()}
    errs = {k: torch.from_numpy(v[rank]).to(dev) for k, v in case["errs"].items()}
    out = {}
    for kind in ("none", "int8", "ef_sign"):
        err = errs if kind == "ef_sign" else {k: torch.zeros(()) for k in errs}
        red, new = compressed_psum_mean(grads, err, kind=kind, mesh=mesh, axis="data")
        out[kind] = ({k: v.cpu() for k, v in red.items()},
                     {k: v.cpu() for k, v in new.items()})
    X = torch.from_numpy(case["X"]).to(dev)
    y = torch.from_numpy(case["y"]).to(dev)

    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"]
        return ((pred - batch["y"]) ** 2).mean(), {}

    final = {}
    for kind in ("none", "ef_sign", "int8"):
        opt = sgd_momentum(constant(0.05), momentum=0.0)
        state = init_state({"w": torch.zeros(X.shape[1], device=dev)}, opt)
        comp = CompressionState.init(state.params, kind)
        step = build_dp_train_step(loss_fn, opt, mesh, compression=kind)
        for _ in range(case["dp_steps"]):
            state, comp, m = step(state, comp, {"x": X, "y": y})
        final[kind] = float(m["loss"])
    out["final_loss"] = final
    return out


def _gpipe(case, mesh, dev):
    """The case's stages (tanh(h @ W_s)) under GPipe over all ranks: the
    outputs and the gradient of sum(y^2) by every stage's W, summed."""
    from repro_torch.distributed.pipeline import build_gpipe_apply
    from repro_torch.launch.mesh import make_stage_mesh

    stages = make_stage_mesh(dist.get_world_size(), dev.type)
    ws = torch.from_numpy(case["Ws"]).to(dev).requires_grad_()
    apply = build_gpipe_apply(lambda w, h: torch.tanh(h @ w), stages)
    y = apply(ws, torch.from_numpy(case["x"]).to(dev))
    (y ** 2).sum().backward()
    g = ws.grad.clone()
    dist.all_reduce(g)
    return {"y": y.detach().cpu(), "grad": g.cpu()}


KINDS = {"dense": _dense, "conv": _conv, "logits": _logits, "engine": _engine,
         "train": _train, "fault": _fault, "ckpt_write": _ckpt_write,
         "ckpt_restore": _ckpt_restore, "dp": _dp, "gpipe": _gpipe}


def start_job(job: dict, world: int, job_dir: Path):
    """Start ``world`` ranks of this script on ``job``, each its own
    process; ``finish_job`` waits for them."""
    import subprocess

    job_dir.mkdir(parents=True, exist_ok=True)
    torch.save(job, job_dir / "job.pt")
    return job_dir, [subprocess.Popen(
        [sys.executable, __file__, str(job_dir)],
        env=dict(os.environ, RANK=str(r), WORLD_SIZE=str(world)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]


def finish_job(started, timeout: float = 120.0):
    """Each rank's results of a started job; a rank that fails or outlives
    ``timeout`` fails the job (the others are stopped)."""
    job_dir, procs = started
    errors = []
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=timeout)
            if p.returncode:
                errors.append(f"rank {r} exited {p.returncode}:\n{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert not errors, "\n".join(errors)
    return [torch.load(job_dir / f"rank{r}.pt", weights_only=False)
            for r in range(len(procs))]


def main(job_dir: str) -> None:
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.set_num_threads(1)
    job = torch.load(Path(job_dir) / "job.pt", weights_only=False)
    dev = torch.device(job["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(str(Path(job_dir) / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    meshes = {tuple(d): _mesh(d, dev) for d in job["meshes"]}
    results = {}
    for i, case in enumerate(job["cases"]):
        for dims in case["meshes"]:
            results[(i, tuple(dims))] = KINDS[case["kind"]](case, meshes[tuple(dims)], dev)
    torch.save(results, Path(job_dir) / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
