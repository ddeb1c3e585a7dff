"""Minimal declarative parameter system (port of ``repro/nn/module.py``).

A layer is a plain dataclass exposing ``specs()`` -> nested dict of
:class:`ParamSpec` and ``__call__(params, *args)`` on tensors. Param trees
are nested dicts keyed exactly like the reference's, so both packages
address the same "/"-joined leaf paths. Each spec names a logical axis
per dim ("heads", "tile_rows", ...); ``logical_axes`` collects them and
``repro_torch.distributed.sharding`` maps them onto a mesh.

Initialization draws from one ``torch.Generator`` per leaf, seeded from
(seed, leaf path): deterministic and independent of tree order, like the
reference's per-path key folding (the numbers differ from JAX's; tests
feed both packages the same numpy arrays instead).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

# init(generator, shape, dtype, device) -> tensor
Initializer = Callable[[torch.Generator, Tuple[int, ...], Any, torch.device],
                       torch.Tensor]


def kaiming() -> Initializer:
    """He-normal over the last (input) axis of a dense weight, or over
    c_in * kh * kw of an OIHW conv weight."""
    def init(gen, shape, dtype, device):
        fan_in = int(np.prod(shape[1:])) if len(shape) > 2 else shape[-1]
        std = float(np.sqrt(2.0 / max(1, fan_in)))
        return std * torch.randn(shape, generator=gen, dtype=dtype, device=device)

    return init


def normal(stddev: float = 0.02) -> Initializer:
    return lambda gen, shape, dtype, device: stddev * torch.randn(
        shape, generator=gen, dtype=dtype, device=device)


def constant_init(v: float) -> Initializer:
    return lambda gen, shape, dtype, device: torch.full(shape, v, dtype=dtype,
                                                        device=device)


def zeros_init() -> Initializer:
    return lambda gen, shape, dtype, device: torch.zeros(shape, dtype=dtype,
                                                         device=device)


def ones_init() -> Initializer:
    return lambda gen, shape, dtype, device: torch.ones(shape, dtype=dtype,
                                                        device=device)


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declaration of one parameter tensor."""

    shape: Tuple[int, ...]
    dtype: Any = torch.float32
    logical: Tuple[Optional[str], ...] = ()  # logical axis name per dim
    init: Initializer = dataclasses.field(default_factory=lambda: normal(0.02))
    # a tiled Dense's TRAIN masters (row-aligned tiling): p, the count of
    # replicas in the row axis (the second-to-last dim, p * r rows); 0
    # elsewhere. ``distributed.sharding.train_shards`` splits such a
    # leaf's r unique rows over the model axis
    tile_p: int = 0

    def __post_init__(self):
        if self.logical and len(self.logical) != len(self.shape):
            raise ValueError(f"logical {self.logical} does not match shape "
                             f"{self.shape}")


SpecTree = Union[ParamSpec, Dict[str, "SpecTree"]]


def walk(tree, path=()):
    """Yield (path tuple, leaf) over a nested dict in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from walk(tree[k], path + (k,))
    elif tree is not None:
        yield path, tree


def get_path(tree: dict, path):
    for k in path:
        tree = tree[k]
    return tree


def set_path(out: dict, path, value) -> None:
    node = out
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def map_tree(fn, tree):
    """Apply ``fn`` to every leaf of a nested dict, keeping its keys."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


# Per-slot state slicing, shared by every serving cache family that keeps a
# slot axis (SSM / RG-LRU carries, windowed-attention rings): one slot's
# rows as a standalone tree, and its inverse. ``axis`` is the slot axis (1
# in a layer-stacked segment). ``slot`` is an int or a 0-d index tensor.
# A tensor slot never leaves the device (a captured graph reads it at each
# replay): it is clamped into range and a slot outside [0, n_slots) reads
# the last slot's rows and writes them back unchanged.
def _slot_index(slot: torch.Tensor, n: int) -> torch.Tensor:
    return slot.clamp(0, n - 1).reshape(1)


def slice_slot_rows(tree, slot, axis: int = 0):
    if isinstance(slot, torch.Tensor):
        return map_tree(lambda v: v.index_select(
            axis, _slot_index(slot, v.shape[axis])).squeeze(axis), tree)
    return map_tree(lambda v: v.select(axis, slot).clone(), tree)


def set_slot_rows(tree, slot, rows, axis: int = 0):
    """Write ``rows`` (a tree of ``tree``'s keys) into the slot's rows of
    ``tree`` in place; returns ``tree``."""
    for path, v in walk(tree):
        new = get_path(rows, path)
        if isinstance(slot, torch.Tensor):
            n = v.shape[axis]
            idx = _slot_index(slot, n)
            new = torch.where((slot >= 0) & (slot < n), new.unsqueeze(axis).to(v.dtype),
                              v.index_select(axis, idx))
            v.index_copy_(axis, idx, new)
        else:
            v.select(axis, slot).copy_(new)
    return tree


def _path_seed(seed: int, path: Tuple[str, ...]) -> int:
    digest = hashlib.md5(f"{seed}:{'/'.join(path)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def init_leaf(spec: ParamSpec, seed: int, path: Tuple[str, ...],
              device) -> torch.Tensor:
    """The leaf at ``path`` of ``init_params(specs, seed, device)``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(_path_seed(seed, path))
    return spec.init(gen, spec.shape, spec.dtype, device)


def init_params(specs: SpecTree, seed: int, device) -> dict:
    """Deterministic, path-seeded parameter initialization on ``device``."""
    out: dict = {}
    for path, spec in walk(specs):
        set_path(out, path, init_leaf(spec, seed, path, device))
    return out


class LazyParams:
    """A read-only view of ``init_params(specs, seed, device)`` that builds a
    leaf each time it is read and keeps none: a reader that drops each leaf
    before it reads the next holds one leaf at a time. Offers what
    ``export_serving_params`` reads of a param tree: ``[key]`` and ``get``."""

    def __init__(self, specs: dict, seed: int, device, path=()):
        self._specs, self._seed, self._device = specs, seed, device
        self._path = tuple(path)

    def __getitem__(self, key: str):
        spec, path = self._specs[key], self._path + (key,)
        if isinstance(spec, ParamSpec):
            return init_leaf(spec, self._seed, path, self._device)
        return LazyParams(spec, self._seed, self._device, path)

    def get(self, key: str, default=None):
        return self[key] if key in self._specs else default


def logical_axes(specs: SpecTree) -> dict:
    """Tree of logical-axis tuples, mirroring the param tree (a leaf that
    names none gets None per dim)."""
    out: dict = {}
    for path, spec in walk(specs):
        set_path(out, path, tuple(spec.logical) if spec.logical
                 else (None,) * len(spec.shape))
    return out


def stack_specs(specs: SpecTree, n: int) -> SpecTree:
    """Prepend a layer axis of size n, named "layers", to every leaf
    (stacked ``seg`` params the model walks with a Python loop)."""
    out: dict = {}
    for path, spec in walk(specs):
        logical = tuple(spec.logical) or (None,) * len(spec.shape)
        set_path(out, path, ParamSpec((n,) + tuple(spec.shape), spec.dtype,
                                      ("layers",) + logical,
                                      _stacked_init(spec.init, n), spec.tile_p))
    return out


def _stacked_init(inner: Initializer, n: int) -> Initializer:
    def init(gen, shape, dtype, device):
        out = torch.empty(shape, dtype=dtype, device=device)
        for i in range(n):      # fill in place: no second copy of the stack
            out[i] = inner(gen, shape[1:], dtype, device)
        return out

    return init
