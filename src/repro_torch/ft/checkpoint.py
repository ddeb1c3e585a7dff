"""npz+json checkpoints with async save (port of ``repro/ft/checkpoint.py``,
same on-disk format, so a checkpoint written by either package restores
in the other).

Layout (one directory per step, atomic via tmp-dir rename):

    <root>/step_00000420/
        manifest.json      tree structure, per-leaf shape/dtype, metadata
        arrays.npz         one entry per leaf, keyed by "/"-joined path

Leaf paths are the reference's: dict keys, NamedTuple field names and
sequence indices joined by "/" (``params/seg0/mixer/wq/w``,
``opt_state/mu/...``, ``opt_state/step``, ``step``). Integer step counters
are stored as int32 scalars, as the reference stores its jnp counters.

The copy to host memory happens on the caller's thread, for CPU tensors
too (the values must be those of the step being saved); serialization and the directory swap run
on a writer thread. Restore copies into the tensors of a template state
in place, so a resumed run holds one copy of the state on the device.

Under a mesh (``CheckpointManager(shardings=)``) a save gathers every
sharded leaf (the masters a rank holds a block of, and their optimizer
moments) to the first rank, which writes the one-device format while the
others wait at a barrier in ``wait()``: one card or any mesh reads the
file, a mesh through ``place`` / ``restore_into(shardings=)``.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import tempfile
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import gather_master, master_block

_STEP_RE = re.compile(r"^step_(\d+)$")
_SEP = "/"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """(key, child) pairs in the reference's flattening order (dict keys
    sorted, as jax sorts them), or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for k, v in kids:
        out.extend(flatten_with_paths(v, f"{prefix}{_SEP}{k}" if prefix else k))
    return out


def _to_host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            raise TypeError("bfloat16 leaves have no numpy dtype here; "
                            "checkpoint float32 masters")
        # always a copy: ``.cpu()`` of a CPU tensor is the tensor itself,
        # which the optimizer goes on updating in place while the writer
        # thread serializes it
        return v.detach().to("cpu", copy=True).numpy()
    if isinstance(v, (bool, np.bool_)):
        return np.asarray(v)
    if isinstance(v, (int, np.integer)):
        return np.asarray(v, np.int32)
    return np.asarray(v)


def _host_leaves(tree, shardings=None) -> List[Tuple[str, np.ndarray]]:
    """(path, host array) of every leaf; under ``shardings`` each sharded
    leaf is first gathered whole (a collective: every rank calls this)."""
    if shardings is None:
        return [(k, _to_host(v)) for k, v in flatten_with_paths(tree)]
    out = []
    for k, v in flatten_with_paths(tree):
        shard = shardings.shard_for(k) if isinstance(v, torch.Tensor) else None
        if shard is not None:
            v = gather_master(v, shard, shardings.mesh)
        out.append((k, _to_host(v)))
    return out


def save_checkpoint(root: os.PathLike, step: int, tree, *,
                    metadata: Optional[Dict[str, Any]] = None) -> pathlib.Path:
    """Synchronous atomic save. Returns the final checkpoint directory."""
    root = pathlib.Path(root)
    root.mkdir(parents=True, exist_ok=True)
    return _write(root, step, _host_leaves(tree), metadata or {})


def _write(root: pathlib.Path, step: int, host, metadata) -> pathlib.Path:
    final = root / f"step_{step:08d}"
    tmp = pathlib.Path(tempfile.mkdtemp(prefix=f".tmp_step_{step:08d}_", dir=root))
    try:
        manifest = {
            "step": int(step),
            "format": 1,
            "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                       for k, v in host},
            "metadata": metadata,
        }
        np.savez(tmp / "arrays.npz", **{k: v for k, v in host})
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def available_steps(root: os.PathLike) -> List[int]:
    root = pathlib.Path(root)
    if not root.exists():
        return []
    out = []
    for d in root.iterdir():
        m = _STEP_RE.match(d.name)
        if m and (d / "manifest.json").exists():
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(root: os.PathLike) -> Optional[int]:
    steps = available_steps(root)
    return steps[-1] if steps else None


def restore_checkpoint(root: os.PathLike, step: Optional[int] = None
                       ) -> Tuple[int, Dict[str, np.ndarray], Dict[str, Any]]:
    """-> (step, path->array dict, metadata). Raises if nothing to restore."""
    root = pathlib.Path(root)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    d = root / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    with np.load(d / "arrays.npz") as z:
        flat = {k: z[k] for k in z.files}
    for k, info in manifest["leaves"].items():
        if list(flat[k].shape) != info["shape"]:
            raise ValueError(f"leaf {k}: stored shape {list(flat[k].shape)} != "
                             f"manifest {info['shape']}")
    return int(manifest["step"]), flat, manifest.get("metadata", {})


@torch.no_grad()
def _fill(template, flat: Dict[str, np.ndarray], prefix: str = "",
          shardings=None):
    kids = _children(template)
    if kids is None:
        arr = flat[prefix]
        if isinstance(template, torch.Tensor):
            shard = None if shardings is None else shardings.shard_for(prefix)
            if shard is not None:
                arr = master_block(torch.from_numpy(arr), shard,
                                   shardings.mesh).numpy()
            if tuple(arr.shape) != tuple(template.shape):
                raise ValueError(f"leaf {prefix}: stored shape {arr.shape} != "
                                 f"{tuple(template.shape)}")
            template.copy_(torch.from_numpy(arr))
            return template
        if isinstance(template, (int, np.integer)):
            return int(arr)
        return arr
    vals = [_fill(v, flat, f"{prefix}{_SEP}{k}" if prefix else k, shardings)
            for k, v in kids]
    if isinstance(template, dict):
        return {k: v for (k, _), v in zip(kids, vals)}
    if _is_namedtuple(template):
        return type(template)(*vals)
    return type(template)(vals)


def restore_into(template, root: os.PathLike, step: Optional[int] = None,
                 shardings=None):
    """Restore into the structure of ``template``: tensor leaves are
    overwritten in place (shapes must match), int leaves replaced. Under
    ``shardings`` (``distributed.sharding.TrainShardings``) ``template``
    holds a rank's blocks and each sharded leaf takes its block of the
    whole leaf on disk. -> (step, tree)."""
    step, flat, _ = restore_checkpoint(root, step)
    missing = [p for p, _ in flatten_with_paths(template) if p not in flat]
    if missing:
        raise KeyError(f"checkpoint missing leaves: {missing[:5]}...")
    return step, _fill(template, flat, shardings=shardings)


def place(tree, shardings):
    """A whole (one-device) tree cut to this rank's blocks under
    ``shardings`` (``distributed.sharding.TrainShardings``; None keeps it
    whole): what the reference's ``place`` does with ``device_put``."""
    if shardings is None:
        return tree

    def cut(path, v):
        shard = shardings.shard_for(path) if isinstance(v, torch.Tensor) else None
        return v if shard is None else master_block(v, shard, shardings.mesh)

    return _map_leaves(cut, tree)


def _map_leaves(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over every leaf, keeping the tree's structure."""
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    vals = [_map_leaves(fn, v, f"{prefix}{_SEP}{k}" if prefix else k)
            for k, v in kids]
    if isinstance(tree, dict):
        return {k: v for (k, _), v in zip(kids, vals)}
    if _is_namedtuple(tree):
        return type(tree)(*vals)
    return type(tree)(vals)


class CheckpointManager:
    """Save-every-N with bounded retention and an async writer thread.
    ``wait()`` drains pending writes: call it before reading
    ``latest_step`` and at shutdown."""

    def __init__(self, root: os.PathLike, *, save_every: int = 100,
                 max_to_keep: int = 3, async_save: bool = True,
                 shardings=None):
        self.root = pathlib.Path(root)
        # under a mesh: saves gather every sharded leaf (all ranks call
        # ``save``), the first rank writes the one-device format, ``wait``
        # ends at a barrier and restores take each rank's blocks
        self.shardings = shardings
        self.save_every = save_every
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self._pending: List[threading.Thread] = []
        self._lock = threading.Lock()
        self._errors: List[Exception] = []

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.save_every == 0

    def save(self, step: int, tree, *, metadata=None, force: bool = False):
        if not force and not self.should_save(step):
            return None
        host = _host_leaves(tree, self.shardings)
        if self.shardings is not None and not self.shardings.is_first():
            return step
        self.root.mkdir(parents=True, exist_ok=True)
        meta = dict(metadata or {})
        if not self.async_save:
            _write(self.root, step, host, meta)
            self._gc()
            return step

        def job():
            try:
                _write(self.root, step, host, meta)
                self._gc()
            except Exception as e:       # surfaced by wait()
                with self._lock:
                    self._errors.append(e)

        t = threading.Thread(target=job, daemon=True)
        with self._lock:
            self._pending = [p for p in self._pending if p.is_alive()]
            self._pending.append(t)
        t.start()
        return step

    def wait(self):
        with self._lock:
            pending = list(self._pending)
        for t in pending:
            t.join()
        with self._lock:
            self._pending.clear()
            err = self._errors[0] if self._errors else None
            self._errors.clear()
        if self.shardings is not None:
            dist.barrier()      # the first rank's writes are on disk
        if err is not None:
            raise err

    def _gc(self):
        with self._lock:
            for s in available_steps(self.root)[: -self.max_to_keep]:
                shutil.rmtree(self.root / f"step_{s:08d}", ignore_errors=True)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.root)

    def restore_into(self, template, step: Optional[int] = None):
        return restore_into(template, self.root, step, self.shardings)
