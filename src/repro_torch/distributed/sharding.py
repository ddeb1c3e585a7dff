"""Logical-axis sharding over a ``(data, model)`` mesh of torch.distributed
ranks (port of ``repro/distributed/sharding.py``, serving half).

Layers name a logical axis per weight dim ("heads", "tile_rows", ...,
``nn/module.ParamSpec.logical``); a rule set maps those names to mesh axes.
The resolution is the reference's, rule for rule: ``param_specs`` gives
every leaf the spec that the reference's ``param_shardings(...,
abstract_tree=)`` builds, with its two sanitizing rules
(``_divisible_spec``): an axis whose extent does not divide its dim drops
to its longest dividing prefix, and a mesh axis shards at most one dim,
the first that claims it (a MoE bank's "experts" before "tile_rows").

There is no GSPMD in PyTorch, so the port realises the placement itself:

* ``place_params`` keeps on each rank only its block of the dims named
  "tile_rows" or "experts" whose resolved spec has a mesh axis: the packed
  tiles of every tiled layer, and a MoE bank's tiles, alphas (and float
  weights) by expert. The router stays whole (routing is replicated), as
  does every other leaf: alphas of plain layers, embeddings, norms, float
  and BWNN heads.
* A tiled layer runs its kernel on the rank's r/TP rows (and its block of
  the batch over "data" where that axis divides m) and ``all_gather``s its
  unique rows (``gather_blocks``) before it replicates them with the whole
  alpha into the whole output. Activations, attention and the K/V pools
  are replicated; ``kernels/ops.py`` and ``nn/moe.py`` hold the per-shard
  branches.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with dim names
("data", "model"); its per-dim process groups carry the collectives.
``param_specs`` and the resolution helpers also take a plain mapping of
axis name -> extent, which needs no process group. Outside ``axis_rules``
every helper reports "no sharding" and no collective runs.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.nn import module as mod

AxisVal = Union[None, str, Tuple[str, ...]]

DEFAULT_RULES: Dict[str, AxisVal] = {
    # weight axes
    "heads": "model",
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "embed": "data",
    "kv": None,
    "conv_spatial": None,
    "layers": None,
    "stage": None,
    # the unique-row axis of a row-packed serve tile: r/TP rows per rank;
    # alphas stay whole (each shard's rows appear in all p replica blocks)
    "tile_rows": "model",
    # activation axes
    "act_batch": ("pod", "data"),
    "act_seq": None,
    "act_res_seq": "model",
    "act_tok": ("pod", "data", "model"),
    "act_cap": ("pod", "data"),
    "act_embed": None,
    "act_heads": "model",
    "act_kv_heads": "model",
    "act_mlp": "model",
    "act_vocab": "model",
    "act_experts": "model",
}

# the logical dims a rank keeps its block of; the leaves kept whole
# whatever their axes name (the router: routing is replicated)
SHARDED_AXES = ("tile_rows", "experts")
WHOLE_LEAVES = ("router",)

Mesh = Union["torch.distributed.device_mesh.DeviceMesh", Mapping[str, int]]


def mesh_extents(mesh: Mesh) -> Dict[str, int]:
    """axis name -> extent, for a DeviceMesh or a plain mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


class _Active(threading.local):
    def __init__(self):
        self.mesh: Optional[Mesh] = None
        self.rules: Optional[Dict[str, AxisVal]] = None


_ACTIVE = _Active()


def _filter_rules(mesh: Mesh, rules: Optional[Dict[str, AxisVal]]):
    """DEFAULT_RULES updated by ``rules``, each value cut to the mesh's
    axes (e.g. "pod" on a one-pod mesh)."""
    names = set(mesh_extents(mesh))

    def keep(v: AxisVal) -> AxisVal:
        if v is None:
            return None
        if isinstance(v, str):
            return v if v in names else None
        kept = tuple(a for a in v if a in names)
        return kept or None

    return {k: keep(v) for k, v in dict(DEFAULT_RULES, **(rules or {})).items()}


@contextlib.contextmanager
def axis_rules(mesh: Mesh, rules: Optional[Dict[str, AxisVal]] = None):
    """Activate the logical -> mesh rules (and the mesh) for a region of
    this thread."""
    prev = (_ACTIVE.mesh, _ACTIVE.rules)
    _ACTIVE.mesh, _ACTIVE.rules = mesh, _filter_rules(mesh, rules)
    try:
        yield
    finally:
        _ACTIVE.mesh, _ACTIVE.rules = prev


def active_mesh() -> Optional[Mesh]:
    return _ACTIVE.mesh


def _as_axes(v: AxisVal) -> Tuple[str, ...]:
    if v is None:
        return ()
    return (v,) if isinstance(v, str) else tuple(v)


def _rule_axes(rule_name: str) -> Tuple[Optional[Mesh], Tuple[str, ...]]:
    """The active mesh and the rule's axes (normalized, cut to the mesh)."""
    mesh, rules = _ACTIVE.mesh, _ACTIVE.rules
    if mesh is None or rules is None:
        return None, ()
    names = mesh_extents(mesh)
    return mesh, tuple(a for a in _as_axes(rules.get(rule_name)) if a in names)


def _mesh_extent(mesh: Mesh, axes: AxisVal) -> int:
    ext = mesh_extents(mesh)
    out = 1
    for a in _as_axes(axes):
        out *= ext[a]
    return out


def _dividing_prefix(mesh: Mesh, axes: Tuple[str, ...], dim: int
                     ) -> Tuple[str, ...]:
    """The longest prefix of ``axes`` whose extent divides ``dim``: the
    rule placement and the per-shard branches both apply, so they cannot
    disagree."""
    for k in range(len(axes), 0, -1):
        if dim % _mesh_extent(mesh, axes[:k]) == 0:
            return axes[:k]
    return ()


def _rule_sharding(rule_name: str, dim: int):
    """(mesh, axes, extent) that a dim of size ``dim`` named ``rule_name``
    shards over: the longest dividing prefix of the rule's axes, or None
    (no active rules, no axis, or extent 1)."""
    mesh, axes = _rule_axes(rule_name)
    if mesh is None or not axes:
        return None
    chosen = _dividing_prefix(mesh, axes, dim)
    extent = _mesh_extent(mesh, chosen)
    return (mesh, chosen, extent) if extent > 1 else None


def tile_sharding(n_rows: int) -> Optional[Tuple[Mesh, Tuple[str, ...], int]]:
    """(mesh, axes, extent) to shard a tile's ``n_rows`` unique rows over,
    or None: no active rules, "tile_rows" maps to no mesh axis, or the
    longest dividing prefix of its axes has extent 1 (TP does not divide
    r)."""
    return _rule_sharding("tile_rows", n_rows)


def expert_sharding(n_experts: int) -> Optional[Tuple[Mesh, Tuple[str, ...], int]]:
    """(mesh, axes, extent) that a MoE bank's E experts shard over (the
    "experts" rule; it claims its axes before "tile_rows"), or None."""
    return _rule_sharding("experts", n_experts)


def batch_shard_axes(exclude: Sequence[str], dim: int) -> Tuple[str, ...]:
    """Axes to shard a batch-like dim of size ``dim`` over inside a
    per-shard branch: the longest dividing prefix of the "act_batch" rule
    minus ``exclude``."""
    mesh, axes = _rule_axes("act_batch")
    if mesh is None:
        return ()
    return _dividing_prefix(mesh, tuple(a for a in axes if a not in exclude), dim)


def spec_from_logical(logical: Sequence[Optional[str]]) -> Tuple[AxisVal, ...]:
    """The active rules' mesh axes for each logical name (no divisibility
    check)."""
    rules = _ACTIVE.rules or {}
    return tuple(rules.get(name) if name else None for name in logical)


def _divisible_spec(mesh: Mesh, shape, spec_axes) -> Tuple[AxisVal, ...]:
    """Sanitize a spec: each dim keeps the longest prefix of its axes that
    divides it, and a mesh axis shards at most one dim (the first that
    claims it wins)."""
    used: set = set()
    out = []
    for dim, ax in zip(shape, spec_axes):
        parts = tuple(a for a in _as_axes(ax) if a not in used)
        cand = _dividing_prefix(mesh, parts, dim) if parts else ()
        if not cand:
            out.append(None)
            continue
        used.update(cand)
        out.append(cand if len(cand) > 1 else cand[0])
    return tuple(out)


def _resolve(logical, rules: Dict[str, AxisVal], names) -> list:
    spec = []
    for name in logical:
        v = rules.get(name) if name else None
        if isinstance(v, str) and v not in names:
            v = None
        if isinstance(v, tuple):
            v = tuple(a for a in v if a in names) or None
        spec.append(v)
    return spec


def param_specs(mesh: Mesh, logical: dict, shapes: dict,
                rules: Optional[Dict[str, AxisVal]] = None) -> dict:
    """The resolved per-leaf spec (a tuple of mesh axes or None per dim)
    of a tree of logical-axis tuples, for leaves of the given shapes (a
    tree of tensors or shape tuples): what the reference's
    ``param_shardings(mesh, logical, abstract_tree=)`` builds."""
    rules = dict(DEFAULT_RULES, **(rules or {}))
    names = set(mesh_extents(mesh))
    out: dict = {}
    for path, lg in mod.walk(logical):
        leaf = mod.get_path(shapes, path)
        shape = tuple(getattr(leaf, "shape", leaf))
        mod.set_path(out, path, _divisible_spec(mesh, shape,
                                                _resolve(lg, rules, names)))
    return out


def shard_index(mesh, axes: Tuple[str, ...]) -> int:
    """This rank's block index along ``axes`` (row-major over them)."""
    ext = mesh_extents(mesh)
    idx = 0
    for a in axes:
        idx = idx * ext[a] + mesh.get_local_rank(a)
    return idx


def local_block(t: torch.Tensor, mesh, axes: Tuple[str, ...], dim: int
                ) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` when ``axes`` split it
    evenly (a view; ``t`` itself for no axes)."""
    if not axes:
        return t
    n = _mesh_extent(mesh, axes)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over "
                         f"{axes} (extent {n})")
    size = t.shape[dim] // n
    return t.narrow(dim, shard_index(mesh, axes) * size, size)


def place_params(params: dict, logical: dict, mesh,
                 rules: Optional[Dict[str, AxisVal]] = None) -> dict:
    """The param tree this rank holds under ``mesh``: each leaf cut to its
    block of every dim named in ``SHARDED_AXES`` whose resolved spec has a
    mesh axis (a copy, so the whole leaf can be freed), except the
    ``WHOLE_LEAVES``; every other leaf as given."""
    specs = param_specs(mesh, logical, params, rules)
    out: dict = {}
    for path, v in mod.walk(params):
        lg, spec = mod.get_path(logical, path), mod.get_path(specs, path)
        cut = v
        if path[-1] not in WHOLE_LEAVES:
            for dim, (name, ax) in enumerate(zip(lg, spec)):
                if name in SHARDED_AXES and ax is not None:
                    cut = local_block(cut, mesh, _as_axes(ax), dim)
        mod.set_path(out, path, v if cut is v else cut.clone())
    return out


def gather_blocks(t: torch.Tensor, mesh, axes: Tuple[str, ...], dim: int
                  ) -> torch.Tensor:
    """The inverse of ``local_block``: every rank's block along ``dim``
    gathered over ``axes`` (innermost axis first) and concatenated in
    block order. A failed collective raises."""
    ext = mesh_extents(mesh)
    for a in reversed(axes):
        if ext[a] == 1:
            continue
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(ext[a])]
        dist.all_gather(parts, t, group=mesh.get_group(a))
        t = torch.cat(parts, dim)
    return t


def sum_over(t: torch.Tensor, mesh, axes: Tuple[str, ...]) -> torch.Tensor:
    """``t`` summed over the ranks of ``axes`` (all_reduce, in place on a
    contiguous copy); every rank gets the same sum."""
    t = t.contiguous()
    for a in axes:
        if mesh_extents(mesh)[a] > 1:
            dist.all_reduce(t, group=mesh.get_group(a))
    return t


def broadcast_from_first(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` as the mesh's first rank holds it, on every rank of the mesh
    (in place)."""
    src = int(mesh.mesh.flatten()[0])
    dist.broadcast(t, src=src)
    return t
