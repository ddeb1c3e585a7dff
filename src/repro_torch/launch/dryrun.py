"""Dry run of every (arch x shape x mesh) cell on the ``meta`` device
(port of ``repro/launch/dryrun.py``).

For each cell this script builds ONE rank's part of it (``launch.cells``:
its params, optimizer state, batch and caches as meta tensors, the mesh a
DeviceMesh over a fake process group of the production mesh's size), runs
the cell's step once on them under ``roofline.analysis.CostCounter`` and
writes one JSON record: the rank's memory (its state and inputs, and the
peak of the bytes the step's ops hold alive) against the card's 80 GB, the
step's counted work (float and integer ops, HBM bytes, kernel calls,
collective bytes and calls by kind), the K/V and state cache bytes the rank
holds (``memory.cache_bytes``: its block of the K/V heads where a "heads"
architecture's model axis divides them, 1/TP of the time rows where a
"seq" architecture's divides their length; ``memory.cache_time_rows``
for a decode cell), and the reference's placement of the batch (and
caches) beside it. A "seq" cell's counted collectives include one
all-gather a layer of the partial softmaxes. Nothing touches a card and
no value is computed.

The port's layer loop dispatches every layer, so the roofline comes from
the full-depth run (no depth-1 / depth-2 extrapolation).

Usage:
  python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback


from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.base import cell_applicable
from repro_torch.distributed.sharding import axis_rules
from repro_torch.launch.cells import (
    build_cell,
    build_decode_cell,
    build_prefill_cell,
    build_train_cell,
    scan_trips,
    tree_bytes,
)
from repro_torch.launch.mesh import ProductionMesh, make_production_mesh
from repro_torch.nn import module as mod
from repro_torch.roofline import hw
from repro_torch.roofline.analysis import CostCounter, model_flops

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def run_plan(plan: dict, mesh, rules=None) -> tuple:
    """(the step's result, its CostCounter): one run of the plan's step on
    its meta args under the mesh's axis rules."""
    counter = CostCounter()
    with axis_rules(mesh, rules), counter:
        out = plan["fn"](*plan["args"])
    return out, counter


def cache_bytes(cell, plan: dict, out) -> int:
    """The K/V and state cache bytes a rank holds in a serve cell: a decode
    step's caches (its arguments), a prefill's (its output); 0 for a train
    cell."""
    if cell.kind == "decode":
        return int(plan["memory"]["cache_bytes"])
    return int(tree_bytes(out[1])) if cell.kind == "prefill" else 0


def count_cell(cfg, cell, dims, page_tokens=None) -> dict:
    """The first rank's counted cell for ``cfg`` (as given: cut it with
    ``cells.depth_cfg`` or ``dataclasses.replace`` first) and ``cell``
    under a ("data", "model") mesh of ``dims`` ((1, 1): one card): the
    kernels launched and the collectives by kind (a "seq" layer's gather
    of its partial softmaxes among them), with their bytes, the
    rank's param bytes (and for a train cell its state: masters and AdamW
    moments), its tile bytes (a serve cell's packed tiles), its cache
    bytes, and the peak of the bytes its step's ops hold alive beside its
    arguments. ``page_tokens`` builds a decode cell on the engine's paged
    pool (``cells.build_decode_cell``)."""
    mesh = ProductionMesh(tuple(dims), ("data", "model")).join()
    if cell.kind == "decode":
        plan = build_decode_cell(cfg, cell, mesh, page_tokens=page_tokens)
    else:
        plan = {"train": build_train_cell,
                "prefill": build_prefill_cell}[cell.kind](cfg, cell, mesh)
    params = plan["args"][0].params if cell.kind == "train" else plan["args"][0]
    out, counter = run_plan(plan, mesh, dict(cfg.rules_override))
    return dict(
        kernels=dict(counter.kernels), coll_calls=dict(counter.coll_calls),
        coll_bytes=dict(counter.coll_bytes), param_bytes=tree_bytes(params),
        tile_bytes=tree_bytes([v for p, v in mod.walk(params)
                               if p[-1] in ("tile", "tile_conv")]),
        cache_bytes=cache_bytes(cell, plan, out),
        state_bytes=plan["memory"].get("state_bytes"),
        argument_bytes=plan["memory"]["argument_bytes"],
        peak_bytes=counter.peak_bytes, terms=counter.terms().as_dict())


def run_cell(arch: str, shape: str, mesh_kind: str, roofline: bool = True) -> dict:
    cfg = get_config(arch)
    cell = SHAPES[shape]
    ok, reason = cell_applicable(cfg, cell)
    rec = dict(arch=arch, shape=shape, mesh=mesh_kind)
    if not ok:
        rec.update(status="skip", reason=reason)
        return rec

    prod = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    mesh = prod.join()
    t0 = time.time()
    plan = build_cell(arch, shape, mesh)
    out, counter = run_plan(plan, mesh, dict(cfg.rules_override))
    t_run = time.time() - t0
    mem = plan["memory"]
    mem_rec = dict(
        argument_bytes=int(mem["argument_bytes"]),
        output_bytes=int(tree_bytes(out)),
        temp_bytes=int(counter.peak_bytes),
        alias_bytes=int(mem["alias_bytes"]),
        cache_bytes=cache_bytes(cell, plan, out),
    )
    if "cache_time_rows" in mem:
        mem_rec["cache_time_rows"] = mem["cache_time_rows"]
    peak = (mem_rec["argument_bytes"] + mem_rec["temp_bytes"]
            + mem_rec["output_bytes"] - mem_rec["alias_bytes"])
    terms = counter.terms()
    rec.update(
        status="ok",
        chips=prod.size,
        meta_s=round(t_run, 1),
        memory=mem_rec,
        peak_bytes_per_device=int(peak),
        fits_hbm=bool(peak <= hw.HBM_BYTES),
        full_cost=counter.as_dict(),
        layouts=plan["layouts"],
    )
    if roofline:
        n_active = active_params(cfg)
        mf = model_flops(cfg, cell, n_active)
        flops_global = terms.flops * prod.size
        rec.update(
            roofline=terms.as_dict(),
            scan_trips=scan_trips(cfg),
            n_params_active=n_active,
            model_flops_global=mf,
            useful_flops_ratio=(mf / flops_global) if flops_global else None,
        )
    return rec


def active_params(cfg) -> int:
    """Parameters touched per token (MoE: routed top-k of E + shared)."""
    from repro_torch.configs import build_model
    from repro_torch.nn.context import TRAIN, ModelContext

    model = build_model(cfg, ModelContext(policy=cfg.tbn, mode=TRAIN,
                                          device="meta"))
    total = 0
    for path, leaf in mod.walk(model.abstract()):
        n = leaf.numel()
        # routed expert banks carry a leading E dim under seg*/ffn/{up,down,gate}/w
        if (
            cfg.moe is not None
            and leaf.ndim == 3
            and any(k in ("up", "down", "gate") for k in path)
            and "shared" not in path
            and leaf.shape[0] == cfg.moe.n_experts
        ):
            n = n * cfg.moe.top_k // cfg.moe.n_experts
        total += n
    return total


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--roofline", action="store_true", default=True)
    ap.add_argument("--no-roofline", dest="roofline", action="store_false")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = []
    if args.all:
        for a in ARCH_IDS:
            for s in SHAPES:
                cells.append((a, s))
    else:
        cells.append((args.arch, args.shape))
    if not args.out:
        RESULTS.mkdir(parents=True, exist_ok=True)

    failures = 0
    t_all = time.time()
    for arch, shape in cells:
        for mk in meshes:
            name = f"{arch}__{shape}__{mk}"
            out = pathlib.Path(args.out) if args.out else RESULTS / f"{name}.json"
            try:
                rec = run_cell(arch, shape, mk, roofline=args.roofline)
            except Exception as e:  # a failing cell is a bug in the system
                rec = dict(arch=arch, shape=shape, mesh=mk, status="error",
                           error=f"{type(e).__name__}: {e}",
                           traceback=traceback.format_exc()[-4000:])
                failures += 1
            out.write_text(json.dumps(rec, indent=2))
            summary = {k: rec.get(k) for k in
                       ("status", "meta_s", "peak_bytes_per_device", "fits_hbm")}
            print(f"{name}: {summary}", flush=True)
    print(f"{len(cells) * len(meshes)} cells in {time.time() - t_all:.1f}s",
          flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
