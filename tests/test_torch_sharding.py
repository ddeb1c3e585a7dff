"""The port's sharding rules against the JAX package's, without a process
group: ``param_specs`` resolves every arch's SERVE tree to the specs the
reference's ``param_shardings(..., abstract_tree=)`` builds on a
``jax.sharding.AbstractMesh`` (no devices needed), at meshes (1, 2),
(2, 2), (1, 4), (2, 4) and (16, 16); ``_divisible_spec``,
``tile_sharding``, ``expert_sharding`` and ``batch_shard_axes`` equal the
reference's, the reference's own TestShardingRules cases included; the
serve CLI's mesh parser keeps the reference's messages and the backend
rule is a pure function of the job's shape."""
import itertools

import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import build_model as j_build_model
from repro.configs import get_config as j_get_config
from repro.distributed import sharding as j_sh
from repro.launch import mesh as j_mesh
from repro.nn import module as j_mod
from repro.nn.context import SERVE as J_SERVE
from repro.nn.context import ModelContext as JModelContext
from repro_torch.configs import build_model, get_config
from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh as mesh_mod
from repro_torch.nn import module as mod
from repro_torch.nn.context import SERVE, ModelContext

MESHES = [(1, 2), (2, 2), (1, 4), (2, 4), (16, 16)]
NAMES = ("data", "model")
DIMS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 256, 50281)
AXES = (None, "data", "model", ("data", "model"), ("model", "data"))


def _meshes(dims):
    return AbstractMesh(dims, NAMES), dict(zip(NAMES, dims))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {"/".join(path): tree}


def _spec(p) -> tuple:
    return tuple(p)


@pytest.fixture
def active(monkeypatch):
    """Activate the rules of a mesh in both packages (the reference's
    ``axis_rules`` enters a concrete mesh, so its state is set directly)."""
    def activate(dims, rules=None):
        j_m, t_m = _meshes(dims)
        filtered = sh._filter_rules(t_m, rules)
        monkeypatch.setattr(j_sh._ACTIVE, "mesh", j_m)
        monkeypatch.setattr(j_sh._ACTIVE, "rules", filtered)
        monkeypatch.setattr(sh._ACTIVE, "mesh", t_m)
        monkeypatch.setattr(sh._ACTIVE, "rules", filtered)
    return activate


@pytest.mark.parametrize("dims", MESHES)
@pytest.mark.parametrize("arch", sorted(J_ARCH_IDS))
def test_param_specs_match_reference(arch, dims):
    cj, ct = j_get_config(arch).reduced(), get_config(arch).reduced()
    jm = j_build_model(cj, JModelContext(policy=cj.tbn, mode=J_SERVE,
                                         compute_dtype=jnp.float32, use_pallas=False))
    tm = build_model(ct, ModelContext(policy=ct.tbn, mode=SERVE,
                                      compute_dtype=torch.float32, device="cpu"))
    j_m, t_m = _meshes(dims)
    want = j_sh.param_shardings(j_m, j_mod.logical_axes(jm.specs()),
                                abstract_tree=j_mod.abstract_params(jm.specs()))
    shapes = mod.map_tree(lambda s: tuple(s.shape), tm.specs())
    got = sh.param_specs(t_m, mod.logical_axes(tm.specs()), shapes)
    want, got = _flat(want), _flat(got)
    assert sorted(got) == sorted(want)
    diff = {k: (got[k], _spec(want[k].spec)) for k in want
            if got[k] != _spec(want[k].spec)}
    assert not diff, diff


def test_reference_sharding_rule_cases():
    _, t_m = _meshes((2, 4))
    assert sh.param_specs(t_m, {"t": ("vocab", "embed")},
                          {"t": (50281, 64)})["t"] == (None, "data")
    # experts takes "model"; mlp (also model) is dropped
    assert sh.param_specs(t_m, {"t": ("experts", "mlp", "embed")},
                          {"t": (8, 16, 32)})["t"] == ("model", None, "data")


@pytest.mark.parametrize("dims", MESHES)
def test_divisible_spec_matches_reference(dims):
    j_m, t_m = _meshes(dims)
    for shape in itertools.product((1, 2, 6, 16, 50281), repeat=2):
        for axes in itertools.product(AXES, repeat=2):
            assert sh._divisible_spec(t_m, shape, axes) == _spec(
                j_sh._divisible_spec(j_m, shape, axes)), (shape, axes)


@pytest.mark.parametrize("rules", [None, {"experts": None},
                                   {"tile_rows": ("data", "model")}])
@pytest.mark.parametrize("dims", MESHES)
def test_trace_time_rules_match_reference(active, dims, rules):
    active(dims, rules)
    for n in DIMS:
        want = j_sh.tile_sharding(n)
        got = sh.tile_sharding(n)
        assert (got is None) == (want is None), n
        if got is not None:
            assert got[1:] == want[1:], n
        for exclude in ((), ("model",), ("data",)):
            assert sh.batch_shard_axes(exclude, n) == j_sh.batch_shard_axes(exclude, n)
        assert sh.spec_from_logical(("experts", "tile_rows", None)) == _spec(
            j_sh.spec_from_logical(("experts", "tile_rows", None)))
        # a bank's E experts: the longest dividing prefix of the
        # "experts" rule, the axes its leading dim claims first
        j_mesh, j_axes = j_sh._rule_axes("experts")
        chosen = j_sh._dividing_prefix(j_mesh, j_axes, n)
        ex = sh.expert_sharding(n)
        assert (ex[1:] if ex else None) == (
            (chosen, j_sh._mesh_extent(j_mesh, chosen))
            if j_sh._mesh_extent(j_mesh, chosen) > 1 else None), n


def test_no_rules_no_sharding():
    assert sh.active_mesh() is None
    assert sh.tile_sharding(64) is None and sh.expert_sharding(8) is None
    assert sh.batch_shard_axes(("model",), 8) == ()
    with sh.axis_rules({"data": 1, "model": 2}):
        assert sh.tile_sharding(64)[1:] == (("model",), 2)
        assert sh.tile_sharding(63) is None
    assert sh.active_mesh() is None


@pytest.mark.parametrize("spec", ["2by2", "x", "1x2x3", "0x2", "2x0", "-1x2"])
def test_parse_mesh_arg_messages_match_reference(spec):
    with pytest.raises(SystemExit) as want:
        j_mesh.parse_mesh_arg(spec)
    with pytest.raises(SystemExit) as got:
        mesh_mod.parse_mesh_arg(spec, world_size=4)
    assert str(got.value) == str(want.value)


def test_parse_mesh_arg_counts_ranks():
    assert mesh_mod.parse_mesh_arg("1x1", world_size=1) is None
    assert mesh_mod.parse_mesh_arg("1X4", world_size=4) == (1, 4)
    assert mesh_mod.parse_mesh_arg("2x2", world_size=4) == (2, 2)
    with pytest.raises(SystemExit, match=r"--mesh 2x4 needs 8 devices, have 4 ranks"):
        mesh_mod.parse_mesh_arg("2x4", world_size=4)
    with pytest.raises(SystemExit, match="needs 2 devices, have 1 ranks"):
        mesh_mod.parse_mesh_arg("1x2", world_size=1)


@pytest.mark.parametrize("local, kind, cards, backend", [
    (2, "cuda", 1, "gloo"), (4, "cuda", 1, "gloo"), (8, "cuda", 4, "gloo"),
    (4, "cuda", 4, "nccl"), (2, "cuda", 8, "nccl"), (1, "cuda", 1, "nccl"),
    (2, "cpu", 0, "gloo"), (4, "cpu", 8, "gloo")])
def test_backend_rule(local, kind, cards, backend):
    got, why = mesh_mod.mesh_backend(local, kind, cards)
    assert got == backend and str(local) in why


def test_backend_rule_counts_the_ranks_of_a_node(monkeypatch):
    """Two nodes of four cards (world 8, four ranks a node): every rank has
    a card of its own, so NCCL; the rule reads LOCAL_WORLD_SIZE, not the
    world."""
    monkeypatch.setattr(mesh_mod, "resolve_device",
                        lambda d: torch.device("cuda"))
    monkeypatch.setattr(mesh_mod.torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(mesh_mod, "rank_device",
                        lambda *a: torch.device("cpu"))
    monkeypatch.setattr(mesh_mod.dist, "is_initialized", lambda: True)
    import torch.distributed.device_mesh as dm
    monkeypatch.setattr(dm, "init_device_mesh", lambda *a, **k: "mesh")
    for k, v in (("WORLD_SIZE", "8"), ("LOCAL_WORLD_SIZE", "4"),
                 ("LOCAL_RANK", "3")):
        monkeypatch.setenv(k, v)
    _, _, backend, why = mesh_mod.init_mesh(2, 4, "cuda")
    assert (backend, why) == ("nccl", "4 ranks on this node's 4 cards: one "
                                      "card per rank")


def test_rank_devices():
    assert mesh_mod.rank_device("cuda", 3, 4) == torch.device("cuda", 3)
    assert mesh_mod.rank_device("cuda", 3, 1) == torch.device("cuda", 0)
    assert mesh_mod.rank_device("cpu", 3, 0) == torch.device("cpu")
