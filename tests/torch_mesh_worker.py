"""One rank of the port's mesh tests (``test_torch_tp_serve.py``,
``test_torch_tp_cuda.py``): joins a gloo job through a ``FileStore`` in the
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


KINDS = {"dense": _dense, "conv": _conv, "logits": _logits, "engine": _engine}


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
