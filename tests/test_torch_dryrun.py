"""The platform layer's cells and dry run (``configs.base`` shape cells,
``launch/mesh.make_production_mesh``, ``launch/cells.py``,
``launch/dryrun.py``) against the JAX package's, on the CPU:

* ``SHAPES``, ``cell_applicable`` (its skip reasons word for word),
  ``depth_cfg``, ``scan_trips``, ``fit_spec`` and ``active_params`` equal
  the reference's for every arch id;
* one rank's parameter bytes (SERVE: ``place_params``; TRAIN:
  ``train_shards``) under (1, 2), (2, 2) and (2, 4) equal the sum of
  ``NamedSharding.shard_shape`` bytes, leaf by leaf, of the dims the port
  splits and every other dim whole, as the port holds them: SERVE tile
  rows and experts at the reference's resolved axes; TRAIN experts at the
  reference's axes, a Dense master's unique rows over "tile_rows" and,
  under FSDP, its columns over "embed";
* in one subprocess (a fake process group of the mesh's size): granite-8b
  at full width and 2 layers counted on ``meta`` gives the collectives a
  train step that phase 5r of ``chip_smoke.py`` measured on ranks of an
  H100 (104 / 13 / 117 at (1, 2) / (2, 1) / (2, 2)), B5 = B2 = 14 L + 1,
  a rank's masters 2.080 / 3.356 GB, and the 62 914 560 tile bytes a rank
  of phase 4r at (1, 2); qwen2-moe-a2.7b's masters a rank hold E / TP
  experts;
* the dry-run CLI's mamba2-370m ``decode_32k`` ``single`` record (the
  reference's own check) has status ok and fits.
Counts are exact.
"""
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import build_model as j_build_model
from repro.configs import cell_applicable as j_cell_applicable
from repro.configs import get_config as j_get_config
from repro.distributed import sharding as j_sh
from repro.launch import cells as j_cells
from repro.nn import module as j_mod
from repro.nn.context import SERVE as J_SERVE
from repro.nn.context import TRAIN as J_TRAIN
from repro.nn.context import ModelContext as JModelContext
from repro_torch.configs import ARCH_IDS, SHAPES, build_model, cell_applicable, get_config
from repro_torch.distributed import sharding as sh
from repro_torch.launch import cells
from repro_torch.launch.mesh import ProductionMesh, make_production_mesh
from repro_torch.nn import module as mod
from repro_torch.nn.context import SERVE, TRAIN, ModelContext

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("data", "model")


@functools.lru_cache(maxsize=None)
def _j_active_params():
    """The reference's ``active_params`` (its module sets XLA_FLAGS for the
    dry run's 512 host devices on import; the flag is put back)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import active_params
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return active_params


def test_shapes_match_reference():
    assert set(SHAPES) == set(J_SHAPES)
    for name, cell in SHAPES.items():
        assert dataclasses.asdict(cell) == dataclasses.asdict(J_SHAPES[name])


@pytest.mark.parametrize("shape", sorted(J_SHAPES))
@pytest.mark.parametrize("arch", sorted(J_ARCH_IDS))
def test_cell_applicable_matches_reference(arch, shape):
    assert sorted(ARCH_IDS) == sorted(J_ARCH_IDS)
    assert cell_applicable(get_config(arch), SHAPES[shape]) == j_cell_applicable(
        j_get_config(arch), J_SHAPES[shape])


@pytest.mark.parametrize("depth", [None, 1, 2])
@pytest.mark.parametrize("arch", sorted(J_ARCH_IDS))
def test_depth_cfg_and_scan_trips_match_reference(arch, depth):
    ct, cj = get_config(arch), j_get_config(arch)
    assert cells.scan_trips(ct) == j_cells.scan_trips(cj)
    got, want = cells.depth_cfg(ct, depth), j_cells.depth_cfg(cj, depth)
    for f in ("n_layers", "enc_layers", "dec_layers", "force_unroll",
              "supports_decode", "subquadratic", "attn_chunk"):
        assert getattr(got, f) == getattr(want, f), f
    assert cells.exact_cfg(ct).attn_chunk == j_cells.exact_cfg(cj).attn_chunk
    assert cells.scan_trips(got) == j_cells.scan_trips(want)


@pytest.mark.parametrize("arch", sorted(J_ARCH_IDS))
def test_active_params_match_reference(arch):
    from repro_torch.launch.dryrun import active_params

    assert active_params(get_config(arch)) == _j_active_params()(j_get_config(arch))


SHAPES_FIT = [(128, 32768), (1, 524288), (32, 8), (256, 4096), (2, 1)]
AXES_FIT = [(("pod", "data"), "model"), ("data", None), (("data", "model"), None),
            ("model", "data"), (None, ("model", "data"))]


@pytest.mark.parametrize("dims", [(1, 2), (2, 2), (2, 4), (16, 16)])
def test_fit_spec_and_batch_axes_match_reference(dims):
    j_mesh = AbstractMesh(dims, NAMES)
    t_mesh = dict(zip(NAMES, dims))
    assert cells.batch_axes(t_mesh) == j_cells.batch_axes(j_mesh)
    for arch in ("granite-8b", "qwen2-moe-a2.7b"):
        assert cells.batch_axes(t_mesh, get_config(arch)) == j_cells.batch_axes(
            j_mesh, j_get_config(arch))
    for shape in SHAPES_FIT:
        for axes in AXES_FIT:
            axes = tuple(a if not isinstance(a, tuple) else
                         tuple(x for x in a if x in NAMES) for a in axes)
            want = tuple(j_cells.fit_spec(j_mesh, shape, *axes).spec)
            want += (None,) * (len(shape) - len(want))
            assert cells.fit_spec(t_mesh, shape, *axes) == want, (shape, axes)


def test_production_mesh_describes_the_reference_extents_on_nodes_of_8():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (one.shape, one.axis_names, one.size) == ((16, 16), NAMES, 256)
    assert (two.shape, two.axis_names, two.size) == (
        (2, 16, 16), ("pod", "data", "model"), 512)
    assert two.extents() == {"pod": 2, "data": 16, "model": 16}


def test_join_leaves_a_fake_group_and_refuses_a_real_one():
    import torch.distributed as dist

    mesh = ProductionMesh((2, 4), NAMES).join()
    assert (mesh.shape, dist.get_backend(), dist.get_world_size()) == (
        (2, 4), "fake", 8)
    assert ProductionMesh((1, 2), NAMES).join().shape == (1, 2)
    dist.destroy_process_group()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="gloo process group is initialized"):
            ProductionMesh((1, 2), NAMES).join()
        assert dist.get_backend() == "gloo"      # the job's group is kept
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# one rank's parameter bytes against the reference's shard shapes
# ---------------------------------------------------------------------------
class _Rank0:
    """Rank 0's view of a (data, model) DeviceMesh, without a process group:
    what ``place_params`` / ``place_train_params`` read of a mesh."""

    def __init__(self, dims):
        self.mesh_dim_names, self.shape = NAMES, tuple(dims)

    def get_local_rank(self, axis):
        return 0


def _j_shape(j_mesh, shape, spec):
    return NamedSharding(j_mesh, P(*spec)).shard_shape(tuple(shape))


@functools.lru_cache(maxsize=None)
def _trees(arch, mode):
    cfg, cj = get_config(arch).reduced(), j_get_config(arch).reduced()
    if mode == "serve":
        tm = build_model(cfg, ModelContext(policy=cfg.tbn, mode=SERVE, device="meta",
                                           param_dtype=torch.bfloat16))
        jm = j_build_model(cj, JModelContext(policy=cj.tbn, mode=J_SERVE))
    else:
        tm = build_model(cfg, ModelContext(policy=cfg.tbn, mode=TRAIN, device="meta",
                                           fsdp_weights=cfg.fsdp_weights))
        jm = j_build_model(cj, JModelContext(policy=cj.tbn, mode=J_TRAIN))
    return cfg, tm, jm


@pytest.mark.parametrize("dims", [(1, 2), (2, 2), (2, 4)])
@pytest.mark.parametrize("mode", ["serve", "train"])
@pytest.mark.parametrize("arch", ["granite-8b", "qwen2-moe-a2.7b", "starcoder2-7b",
                                  "seamless-m4t-large-v2"])
def test_rank_param_bytes_equal_reference_shard_shapes(arch, mode, dims):
    cfg, tm, jm = _trees(arch, mode)
    j_mesh, t_mesh = AbstractMesh(dims, NAMES), dict(zip(NAMES, dims))
    specs = tm.specs()
    j_specs = _flat_specs(j_sh.param_shardings(
        j_mesh, j_mod.logical_axes(jm.specs()),
        abstract_tree=j_mod.abstract_params(jm.specs())))
    abstract = mod.abstract_params(specs)
    if mode == "serve":
        placed = sh.place_params(abstract, tm.logical(), _Rank0(dims))
    else:
        shards = sh.train_shards(specs, t_mesh, fsdp=cfg.fsdp_weights)
        placed = sh.place_train_params(abstract, shards, _Rank0(dims))
    got = want = 0
    for path, spec in mod.walk(specs):
        key = "/".join(path)
        ref_spec = tuple(j_specs[key]) + (None,) * (len(spec.shape) - len(j_specs[key]))
        keep = []
        if mode == "serve":
            for dim, (name, ax) in enumerate(zip(spec.logical, ref_spec)):
                split = (name in sh.SHARDED_AXES and path[-1] not in sh.WHOLE_LEAVES)
                keep.append(ax if split else None)
        else:
            shard = mod.get_path(shards, path)
            keep = [None] * len(spec.shape)
            if shard is not None and shard.experts:
                # the experts dim at the reference's own axes
                assert shard.experts == (ref_spec[shard.experts_dim],)
                keep[shard.experts_dim] = ref_spec[shard.experts_dim]
            elif shard is not None:
                # a rank holds r / TP unique rows of each of the p replicas
                # (the "tile_rows" rule), and its n_in block under FSDP:
                # the counts of splitting the (p r, n_in) leaf over them
                keep[-2] = shard.rows or None
                keep[-1] = shard.cols or None
        shape = _j_shape(j_mesh, spec.shape, keep)
        leaf = mod.get_path(placed, path)
        assert tuple(leaf.shape) == tuple(shape), (key, keep)
        itemsize = leaf.element_size()
        got += leaf.numel() * itemsize
        want += math.prod(shape) * itemsize
    assert got == want


def _flat_specs(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_specs(v, path + (k,)))
        return out
    return {"/".join(path): tree.spec}


# ---------------------------------------------------------------------------
# counted cells (a fake process group, in a subprocess)
# ---------------------------------------------------------------------------
_COUNT_SCRIPT = r"""
import dataclasses, json, sys
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.launch.dryrun import count_cell

out = {}
g2 = dataclasses.replace(get_config("granite-8b"), n_layers=2)
for dims in ((1, 1), (1, 2), (2, 1), (2, 2)):
    r = count_cell(g2, ShapeCell("5r", 512, 4, "train"), dims)
    out["granite_train_%dx%d" % dims] = {k: r[k] for k in (
        "kernels", "coll_calls", "param_bytes", "state_bytes")}
for dims in ((1, 1), (1, 2)):
    r = count_cell(get_config("granite-8b"), ShapeCell("d", 64, 4, "decode"), dims)
    out["granite_serve_%dx%d" % dims] = {k: r[k] for k in ("kernels", "tile_bytes")}
moe = get_config("qwen2-moe-a2.7b").reduced()
for dims in ((1, 1), (1, 2), (2, 2)):
    r = count_cell(moe, ShapeCell("m", 16, 4, "train"), dims)
    out["moe_train_%dx%d" % dims] = {k: r[k] for k in (
        "kernels", "coll_calls", "param_bytes")}
print(json.dumps(out))
"""


@functools.lru_cache(maxsize=None)
def _counts():
    res = subprocess.run([sys.executable, "-c", _COUNT_SCRIPT], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("dims,calls", [((1, 2), {"all-reduce": 75, "all-gather": 29}),
                                        ((2, 1), {"all-reduce": 13}),
                                        ((2, 2), {"all-reduce": 88, "all-gather": 29})])
def test_dry_run_counts_phase_5r_collectives(dims, calls):
    """Phase 5r of chip_smoke.py counts 104 / 13 / 117 collectives a step on
    ranks sharing one H100 (PERF.md §5); the meta count is the same step's."""
    got = _counts()[f"granite_train_{dims[0]}x{dims[1]}"]
    assert got["coll_calls"] == calls
    assert got["kernels"] == {"B5": 2 * 7 * 2 + 1, "B2": 2 * 7 * 2 + 1}


def test_dry_run_counts_rank_bytes_of_phases_4r_and_5r():
    c = _counts()
    one, tp = c["granite_train_1x1"], c["granite_train_1x2"]
    assert one["coll_calls"] == {} and one["param_bytes"] == 3_355_525_120
    assert tp["param_bytes"] == 2_080_456_704      # 5r: 2.080 GB a rank
    assert one["state_bytes"] == 3 * one["param_bytes"]    # masters + 2 moments
    serve = c["granite_serve_1x2"]
    assert serve["tile_bytes"] == 62_914_560       # 4r: 62.915 MB a rank
    assert 2 * serve["tile_bytes"] == c["granite_serve_1x1"]["tile_bytes"]
    assert serve["kernels"] == {"B1": 7 * 36 + 1}


def test_dry_run_counts_moe_experts_a_rank():
    c = _counts()
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    model = build_model(cfg, ModelContext(policy=cfg.tbn, device="meta"))
    bank = sum(math.prod(s.shape) * 4 for p, s in mod.walk(model.specs())
               if "experts" in s.logical and p[-1] != "router")
    one, tp, dp_tp = (c[f"moe_train_{k}"] for k in ("1x1", "1x2", "2x2"))
    assert one["param_bytes"] - tp["param_bytes"] >= bank // 2
    assert tp["param_bytes"] == dp_tp["param_bytes"]
    assert tp["coll_calls"]["all-reduce"] > one.get("coll_calls", {}).get("all-reduce", 0)


def test_dryrun_cli_single_cell(tmp_path):
    """The reference's own check (``tests/test_launch.py``)."""
    out_file = tmp_path / "cell.json"
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "mamba2-370m",
         "--shape", "decode_32k", "--mesh", "single", "--no-roofline",
         "--out", str(out_file)], cwd=ROOT, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=300)
    assert res.returncode == 0, res.stderr[-2500:]
    rec = json.loads(out_file.read_text())
    assert rec["status"] == "ok" and rec["fits_hbm"]
    assert rec["chips"] == 256 and rec["peak_bytes_per_device"] > 0
    assert rec["full_cost"]["coll_breakdown"]           # the tile gathers
    skip = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "granite-8b",
         "--shape", "long_500k", "--mesh", "single", "--out", str(out_file)],
        cwd=ROOT, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=300)
    assert skip.returncode == 0
    assert json.loads(out_file.read_text()) == {
        "arch": "granite-8b", "shape": "long_500k", "mesh": "single",
        "status": "skip", "reason": "SKIP: full-attention (needs sub-quadratic)"}
