"""TRAIN masters -> shipped SERVE representation, and the weight carrier
from the JAX package's param trees (port of ``repro/serve/weights.py``).

    tiled Dense (aligned)   -> row-packed tile (r, ceil(n_in/32)) int32 + alpha
    tiled Conv2D (aligned)  -> conv-layout tile (kh*kw, r, ceil(c_in/32)) + alpha
    tiled layer (unaligned) -> flat packed tile (ceil(q/32),) int32 + alpha
    BWNN layer (below lambda) -> row-packed sign bits (rows, ceil(rest/32))
                               + one alpha
    kept-dense leaf / norm / embedding -> cast to the serve decl's dtype

The converter pairs the TRAIN and SERVE spec trees of one architecture
and dispatches on the serve node's keys, so it handles stacked (layer
axis) leaves without per-model code.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.packing import pack_bits, pack_conv_tile, packed_len
from repro_torch.core.policy import TBNPolicy
from repro_torch.core.tiling import (
    TileSpec,
    compute_alpha,
    plan_conv_tiling,
    plan_tiling,
    tile_vector,
)
from repro_torch.nn import module as mod


def _derive_layer_spec(policy: TBNPolicy, layer_shape: Tuple[int, ...]):
    return plan_tiling(
        layer_shape, p=policy.p, min_size=policy.min_size,
        alpha_mode=policy.alpha_mode, alpha_source=policy.alpha_source,
        ste=policy.ste, require_aligned=policy.require_aligned,
    )


def _tile_and_alpha(w, a, spec: TileSpec):
    """The shipped (t ±1 (q,), alpha (n_alpha,)) of one layer."""
    t = tile_vector(w.float(), spec)
    src = a if (spec.alpha_source == "A" and a is not None) else w
    return t, compute_alpha(src.float(), spec)


def _export_tiled(w, a, spec: TileSpec):
    t, alpha = _tile_and_alpha(w, a, spec)
    return pack_bits(t), alpha


def _export_tiled_rows(w, a, spec: TileSpec):
    t, alpha = _tile_and_alpha(w, a, spec)
    n_in = spec.n // spec.shape[0]
    return pack_bits(t.reshape(spec.rows_per_tile, n_in)), alpha


def _export_conv_tiled(w, a, spec: TileSpec):
    """Conv-layout packed tile (kh*kw, r, ceil(c_in/32)) + alpha: the same
    tile bits as ``_export_tiled``, laid out per kernel position so kernel
    B6 reads them as shipped."""
    plan = plan_conv_tiling(spec)
    t, alpha = _tile_and_alpha(w, a, spec)
    kh, kw = plan.kernel
    return pack_conv_tile(t, plan.r, plan.c_in, kh, kw), alpha


def _export_bwnn(w, _a=None):
    """Row-packed sign bits + one alpha (mean|W| in f32) for one weight:
    rows are the leading dim, the rest flattens into the packed axis (dense
    (n_out, n_in) rows and OIHW (c_out, c_in*kh*kw) filters alike)."""
    alpha = w.float().abs().mean().reshape(1)
    rows = torch.where(w > 0, 1.0, -1.0).reshape(w.shape[0], -1)
    return pack_bits(rows), alpha


def _per_layer(fn, w, a, n_lead: int):
    """Apply a one-layer export over ``n_lead`` leading (stacked) axes, one
    layer at a time (the reference's vmap; a loop keeps the temporaries to
    one layer's size)."""
    if n_lead == 0:
        return fn(w, a)
    lead = w.shape[:n_lead]
    wl = w.reshape(-1, *w.shape[n_lead:])
    al = a.reshape(-1, *a.shape[n_lead:])
    tiles, alphas = zip(*(fn(wl[i], al[i]) for i in range(wl.shape[0])))
    tile, alpha = torch.stack(tiles), torch.stack(alphas)
    return (tile.reshape(*lead, *tile.shape[1:]),
            alpha.reshape(*lead, *alpha.shape[1:]))


def _with_bias(out: Dict, sv_spec, tr_par) -> Dict:
    if "b" in sv_spec:
        out["b"] = tr_par["b"].to(sv_spec["b"].dtype)
    return out


def export_serving_params(train_specs: mod.SpecTree, serve_specs: mod.SpecTree,
                          train_params: Dict, policy: TBNPolicy) -> Dict:
    """Walk the two spec trees; emit the SERVE param tree from masters."""

    def convert(tr_spec, sv_spec, tr_par):
        keys = set(sv_spec)
        if "tile_conv" in keys:                 # tiled Conv2D
            tile_decl = sv_spec["tile_conv"]
            w = tr_par["w"]
            a = tr_par.get("a", w)
            n_lead = len(tile_decl.shape) - 3
            layer_shape = tuple(w.shape[n_lead:])
            spec = _derive_layer_spec(policy, layer_shape)
            plan = plan_conv_tiling(spec)
            if (plan is None or plan.packed_shape() != tuple(tile_decl.shape[n_lead:])
                    or spec.n_alpha != sv_spec["alpha"].shape[-1]):
                raise ValueError(
                    f"derived conv plan does not match serve decl "
                    f"{tuple(tile_decl.shape)} for shape {layer_shape}")
            tile, alpha = _per_layer(
                lambda we, ae: _export_conv_tiled(we, ae, spec), w, a, n_lead)
            return _with_bias({"tile_conv": tile, "alpha": alpha}, sv_spec, tr_par)
        if "wbits" in keys:                     # BWNN layer
            w = tr_par["w"]
            n_lead = len(sv_spec["wbits"].shape) - 2
            bits, alpha = _per_layer(_export_bwnn, w, w, n_lead)
            return _with_bias({"wbits": bits, "alpha": alpha}, sv_spec, tr_par)
        if "tile" in keys:
            tile_decl: mod.ParamSpec = sv_spec["tile"]
            alpha_decl: mod.ParamSpec = sv_spec["alpha"]
            w = tr_par["w"]
            a = tr_par.get("a", w)
            exported = None
            if len(tile_decl.shape) >= 2:       # row-packed over (n_out, n_in)
                n_lead = len(tile_decl.shape) - 2
                layer_shape = tuple(w.shape[n_lead:])
                spec = _derive_layer_spec(policy, layer_shape)
                if (len(layer_shape) == 2 and spec is not None
                        and spec.aligned_rows
                        and (spec.rows_per_tile, packed_len(layer_shape[1]))
                        == tuple(tile_decl.shape[n_lead:])
                        and spec.n_alpha == alpha_decl.shape[-1]):
                    exported = _per_layer(
                        lambda we, ae: _export_tiled_rows(we, ae, spec),
                        w, a, n_lead)
            if exported is None:                # flat q-bit form
                n_lead = len(tile_decl.shape) - 1
                layer_shape = tuple(w.shape[n_lead:])
                spec = _derive_layer_spec(policy, layer_shape)
                if (spec is None or packed_len(spec.q) != tile_decl.shape[-1]
                        or spec.n_alpha != alpha_decl.shape[-1]):
                    raise ValueError(
                        f"derived spec does not match serve decl "
                        f"{tuple(tile_decl.shape)} for shape {layer_shape}")
                exported = _per_layer(
                    lambda we, ae: _export_tiled(we, ae, spec), w, a, n_lead)
            tile, alpha = exported
            return _with_bias({"tile": tile, "alpha": alpha}, sv_spec, tr_par)
        out = {}
        for k, decl in sv_spec.items():
            if isinstance(decl, mod.ParamSpec):
                out[k] = tr_par[k].to(decl.dtype)
            else:
                out[k] = convert(tr_spec[k], decl, tr_par[k])
        return out

    return convert(train_specs, serve_specs, train_params)


def _to_tensor(arr, device) -> torch.Tensor:
    arr = np.array(arr)  # writable, contiguous copy
    if arr.dtype.name == "bfloat16":   # ml_dtypes bf16: carry the bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_numpy(tree: Dict, device) -> Dict:
    """A param tree of numpy arrays (nested dicts, e.g. a JAX param tree
    after ``jax.tree.map(np.asarray, params)``) -> the same key paths as
    torch tensors on ``device``. Works for TRAIN masters and SERVE trees."""
    return mod.map_tree(lambda v: _to_tensor(v, device), tree)


def serving_bytes(params) -> int:
    """Exact bytes of a param tree."""
    return sum(v.numel() * v.element_size() for _, v in mod.walk(params))


def spec_bytes(specs) -> int:
    """Exact bytes of the param tree a spec tree declares, without building
    it."""
    return sum(int(np.prod(spec.shape)) * spec.dtype.itemsize
               for _, spec in mod.walk(specs))


def tile_serving_bytes(params) -> int:
    """Bytes of the packed tile bits alone (``tile`` and ``tile_conv``)."""
    return sum(v.numel() * v.element_size() for path, v in mod.walk(params)
               if path[-1] in ("tile", "tile_conv"))


def per_device_tile_bytes(params, mesh=None) -> Dict[str, int]:
    """Bytes of packed tile bits resident on each rank: ``{"rank i
    (device)": bytes}`` over the ranks of ``mesh``, gathered with
    ``all_gather_object``, where each rank passes the tree it holds
    (``distributed.sharding.place_params``: 1/TP of every sharded tile).
    Without a mesh, one entry ``{device: bytes}`` for ``params`` as
    given."""
    tiles = [v for path, v in mod.walk(params) if path[-1] in ("tile", "tile_conv")]
    dev = str(tiles[0].device) if tiles else "host"
    local = sum(v.numel() * v.element_size() for v in tiles)
    if mesh is None:
        return {dev: local}
    import torch.distributed as dist

    entries = [None] * dist.get_world_size()
    dist.all_gather_object(entries, (dist.get_rank(), dev, local))
    ranks = {int(r) for r in mesh.mesh.flatten()}
    return {f"rank {r} ({d})": b for r, d, b in entries if r in ranks}
