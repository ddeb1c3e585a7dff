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
import dataclasses
import threading
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

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


@contextlib.contextmanager
def _rules_as(mesh, rules):
    prev = (_ACTIVE.mesh, _ACTIVE.rules)
    _ACTIVE.mesh, _ACTIVE.rules = mesh, rules
    try:
        yield
    finally:
        _ACTIVE.mesh, _ACTIVE.rules = prev


# the outputs the "dots" policy saves: the matrix products (aten's, and
# kernels B1 / B2, ``kernels/_op.py``)
DOT_OPS = frozenset({
    "aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm", "aten::matmul",
    "repro_torch::tiled_matvec_unique", "repro_torch::tiled_matmul_unique"})


def dots_policy(ctx, op, *args, **kwargs):
    """The selective-checkpoint policy of ``remat="dots"`` (the reference's
    ``jax.checkpoint_policies.checkpoint_dots``): save every matrix
    product's output (``DOT_OPS``), recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op._schema.name in DOT_OPS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn, *args, policy=None):
    """``torch.utils.checkpoint`` (non-reentrant) whose recompute runs under
    the axis rules its forward ran under: the backward of CUDA tensors runs
    in autograd's device thread, which the thread-local rules do not
    reach, and a rank's tiled layers must take their per-shard branch
    there too. ``policy`` (e.g. ``dots_policy``) makes it a selective
    checkpoint: the outputs it saves are kept from the forward, the rest
    recomputed."""
    from torch.utils.checkpoint import (
        checkpoint,
        create_selective_checkpoint_contexts,
    )

    mesh, rules = _ACTIVE.mesh, _ACTIVE.rules

    def contexts():
        if policy is None:
            fwd, rec = contextlib.nullcontext(), contextlib.nullcontext()
        else:
            fwd, rec = create_selective_checkpoint_contexts(policy)

        @contextlib.contextmanager
        def recompute():
            with rec, _rules_as(mesh, rules):
                yield

        return fwd, recompute()

    return checkpoint(fn, *args, use_reentrant=False, context_fn=contexts)


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


def data_parallel_axes() -> Optional[Tuple[Mesh, Tuple[str, ...], int]]:
    """(mesh, axes, extent) of the active "act_batch" rule's axes of extent
    > 1: the axes a training step splits its global batch over
    (``train.step.dp_rows``), or None."""
    mesh, axes = _rule_axes("act_batch")
    if mesh is None:
        return None
    axes = tuple(a for a in axes if mesh_extents(mesh)[a] > 1)
    return (mesh, axes, _mesh_extent(mesh, axes)) if axes else None


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


# ---------------------------------------------------------------------------
# Training half: where a rank's masters live, and the collectives of the
# per-shard train branches (differentiable, Megatron-style)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MasterShard:
    """How a rank holds one TRAIN leaf. A tiled Dense's (p * r, n_in)
    masters (its last two dims): ``rows`` are the mesh axes that split each
    replica's r unique rows (a rank on model index t keeps rows
    [t r/TP, (t+1) r/TP) of every replica), ``cols`` the axes that split
    n_in (``fsdp_weights``). A MoE expert bank: ``experts`` are the axes
    that split its E experts (dim ``experts_dim``; a rank on model index t
    keeps experts [t E/TP, (t+1) E/TP)), as serving's expert parallelism
    places its banks."""

    p: int
    rows: Tuple[str, ...] = ()
    cols: Tuple[str, ...] = ()
    experts: Tuple[str, ...] = ()
    experts_dim: int = 0

    @property
    def axes(self) -> Tuple[str, ...]:
        """Every axis that splits the leaf."""
        return tuple(self.rows) + tuple(self.cols) + tuple(self.experts)


def _axis_for(mesh, rules: Dict[str, AxisVal], name: str, dim: int
              ) -> Tuple[str, ...]:
    """The longest dividing prefix of rule ``name``'s axes for a dim of
    size ``dim`` (extent-1 axes dropped)."""
    ext = mesh_extents(mesh)
    axes = tuple(a for a in _as_axes(rules.get(name)) if a in ext)
    chosen = _dividing_prefix(mesh, axes, dim)
    return chosen if _mesh_extent(mesh, chosen) > 1 else ()


def train_shards(specs, mesh, *, fsdp: bool = False,
                 rules: Optional[Dict[str, AxisVal]] = None) -> dict:
    """Per TRAIN leaf, its ``MasterShard`` or None (kept whole). A leaf with
    ``ParamSpec.tile_p`` (a row-aligned tiled Dense's ``w`` / ``a``) splits
    its r unique rows over the "tile_rows" rule's axes where their extent
    divides r, and under ``fsdp`` its n_in over the "embed" rule's axes
    where theirs divides n_in (the ``_divisible_spec`` rules: a ragged dim
    stays whole). A MoE expert bank's masters split their E experts over
    the "experts" rule's axes where their extent divides E (a rank holds
    E/TP experts' masters). The router and every other leaf stay whole."""
    rules = _filter_rules(mesh, rules)
    out: dict = {}
    for path, spec in mod.walk(specs):
        shard = None
        if path[-1] in WHOLE_LEAVES:
            pass
        elif "experts" in spec.logical:
            dim = spec.logical.index("experts")
            ep = _axis_for(mesh, rules, "experts", spec.shape[dim])
            if ep:
                shard = MasterShard(1, experts=ep, experts_dim=dim)
        elif spec.tile_p:
            rows_n, n_in = spec.shape[-2], spec.shape[-1]
            rows = _axis_for(mesh, rules, "tile_rows", rows_n // spec.tile_p)
            cols = _axis_for(mesh, rules, "embed", n_in) if fsdp else ()
            if rows or cols:
                shard = MasterShard(spec.tile_p, rows, cols)
        mod.set_path(out, path, shard)
    return out


def _rows_view(t: torch.Tensor, p: int) -> torch.Tensor:
    """(..., p * r, n) -> (..., p, r, n)."""
    return t.unflatten(-2, (p, t.shape[-2] // p))


def master_block(t: torch.Tensor, shard: Optional[MasterShard], mesh
                 ) -> torch.Tensor:
    """This rank's block of a whole leaf (a copy, so the whole can go)."""
    if shard is None:
        return t
    if shard.experts:
        return local_block(t, mesh, shard.experts, shard.experts_dim).clone()
    v = _rows_view(t, shard.p)
    v = local_block(local_block(v, mesh, shard.rows, -2), mesh, shard.cols, -1)
    return v.flatten(-3, -2).clone()


def gather_master(t: torch.Tensor, shard: Optional[MasterShard], mesh
                  ) -> torch.Tensor:
    """The inverse of ``master_block``: the whole leaf on every rank."""
    if shard is None:
        return t
    if shard.experts:
        return gather_blocks(t, mesh, shard.experts, shard.experts_dim)
    v = gather_blocks(_rows_view(t, shard.p), mesh, shard.cols, -1)
    return gather_blocks(v, mesh, shard.rows, -2).flatten(-3, -2)


def _map_shards(fn, tree: dict, shards: dict, mesh) -> dict:
    out: dict = {}
    for path, v in mod.walk(tree):
        mod.set_path(out, path, fn(v, mod.get_path(shards, path), mesh))
    return out


def place_train_params(params: dict, shards: dict, mesh) -> dict:
    """The TRAIN tree this rank holds: each sharded leaf cut to its block
    (``master_block``), every other leaf as given."""
    return _map_shards(master_block, params, shards, mesh)


def gather_train_params(params: dict, shards: dict, mesh) -> dict:
    """Every rank's blocks gathered into the whole TRAIN tree (the
    one-device layout), on every rank."""
    return _map_shards(gather_master, params, shards, mesh)


class _CopyToShards(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``axes`` (each
    rank's gradient is the part its shard of rows contributes)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # summed in f32 whatever the compute dtype
        return (sum_over(g.to(torch.float32, copy=True), ctx.mesh,
                         ctx.axes).to(g.dtype),
                None, None)


class _SumShards(torch.autograd.Function):
    """all_reduce forward; the backward sums the gradient over ``axes`` too
    (each rank's output feeds only its own shard's part of the loss)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return sum_over(x.clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return sum_over(g.clone(), ctx.mesh, ctx.axes), None, None


class _GatherShards(torch.autograd.Function):
    """``gather_blocks`` forward; the backward is this rank's block of the
    gradient (every rank holds the same whole gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return gather_blocks(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (local_block(g, ctx.mesh, ctx.axes, ctx.dim).contiguous(),
                None, None, None)


class _GatherReduceScatter(torch.autograd.Function):
    """``gather_blocks`` forward over axes whose ranks hold different data
    (FSDP over "data"); the backward reduce-scatters: the gradient summed
    over ``axes``, this rank's block of it."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return gather_blocks(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        g = sum_over(g.contiguous().clone(), ctx.mesh, ctx.axes)
        return (local_block(g, ctx.mesh, ctx.axes, ctx.dim).contiguous(),
                None, None, None)


class _ReduceShards(torch.autograd.Function):
    """all_reduce forward; the backward passes the gradient through (every
    rank computes the whole loss from the whole sum, so each rank's part
    gets the same gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return sum_over(x.clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def reduce_shards(x, mesh, axes):
    return _ReduceShards.apply(x, mesh, axes) if axes else x


def copy_to_shards(x, mesh, axes):
    return _CopyToShards.apply(x, mesh, axes) if axes else x


def sum_shards(x, mesh, axes):
    return _SumShards.apply(x, mesh, axes) if axes else x


def gather_shards(x, mesh, axes, dim):
    return _GatherShards.apply(x, mesh, axes, dim) if axes else x


def fsdp_gather(w, mesh, axes):
    """A master's n_in blocks gathered over ``axes`` at use; its gradient
    is reduce-scattered back (summed over the data ranks)."""
    return _GatherReduceScatter.apply(w, mesh, axes, -1) if axes else w


def dense_train_shards(r: int, n_in: int, fsdp: bool):
    """(mesh, rows axes, cols axes) of a tiled Dense's masters under the
    active rules, as ``train_shards`` placed them, or None outside a mesh
    (or when neither dim is split)."""
    mesh, rules = _ACTIVE.mesh, _ACTIVE.rules
    if mesh is None or rules is None:
        return None
    rows = _axis_for(mesh, rules, "tile_rows", r)
    cols = _axis_for(mesh, rules, "embed", n_in) if fsdp else ()
    return (mesh, rows, cols) if rows or cols else None


@dataclasses.dataclass(frozen=True)
class TrainShardings:
    """A training run's placement: its mesh and the ``train_shards`` tree of
    its params. A leaf of a larger tree (a ``TrainState``: params, the
    optimizer's moments of the same shapes, counters) takes the shard of
    the param whose path it ends with."""

    mesh: Any
    shards: dict

    def shard_for(self, path: str) -> Optional[MasterShard]:
        """The shard of the "/"-joined leaf ``path``: the longest param
        path it ends with, or None (a whole leaf)."""
        best, found = -1, None
        for p, shard in mod.walk(self.shards):
            key = "/".join(p)
            if (path == key or path.endswith("/" + key)) and len(key) > best:
                best, found = len(key), shard
        return found

    def is_first(self) -> bool:
        """Whether this is the job's first rank (it writes checkpoints)."""
        return dist.get_rank() == int(self.mesh.mesh.flatten()[0])


def world_all_true(flag: bool, mesh) -> bool:
    """Whether ``flag`` holds on every rank of ``mesh`` (an all_reduce of 0
    / 1, MIN, over all its ranks)."""
    t = torch.tensor([1 if flag else 0], dtype=torch.int32,
                     device=_mesh_device(mesh))
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")
