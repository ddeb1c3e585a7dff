"""Build (function, args) for every dry-run cell (port of
``repro/launch/cells.py``).

A cell = (architecture x input shape x mesh). Three kinds:
  train   — train_step  : (TrainState, batch) -> (TrainState, metrics)
  prefill — prefill_fn  : (params, batch)     -> (logits, caches, lengths)
  decode  — decode_fn   : (params, tokens, caches, lengths) -> (...)

Each builder makes ONE rank's part of the cell on the ``meta`` device (no
storage, nothing computed), through the port's own placement: the train
cell's masters cut by ``distributed.sharding.train_shards`` /
``place_train_params`` and its rows of the global batch taken by the step
(``train.step.dp_rows``); a serve cell's params cut by ``place_params``
(tile rows and expert banks), its caches built under the cell's rules (an
architecture whose ``attn_act`` is "heads" holds its block of the K/V
heads where the model axis divides them, ``nn/attention.Attention.heads``;
one whose ``attn_act`` is "seq" 1/TP of every cache's time rows where the
model axis divides their length, ``Attention.seq_block``, and gathers
each layer's partial softmaxes), its batch and activations whole, as the
port serves under a mesh.
The mesh is a DeviceMesh over a fake process group of the mesh's size
(``launch.mesh.ProductionMesh.join``), so the collectives run and move
nothing. Running ``fn(*args)`` under ``roofline.analysis.CostCounter``
counts the rank's work.

The reference compiles depth-1 and depth-2 variants and extrapolates,
because XLA's cost analysis visits a scanned layer once. The port's layer
loop is a Python loop that dispatches every layer's ops, so the counter
sees the full depth and no extrapolation is needed; ``depth_cfg`` (a
config cut in depth, per-layer dims exact) and ``scan_trips`` are kept for
cut runs and the record.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import build_model, get_config
from repro_torch.configs.base import ArchConfig, SHAPES, ShapeCell, cell_applicable
from repro_torch.distributed.sharding import (
    DEFAULT_RULES,
    axis_rules,
    mesh_extents,
    place_params,
    place_train_params,
    slot_sharding,
    train_shards,
)
from repro_torch.nn import module as mod
from repro_torch.nn.context import SERVE, TRAIN, ModelContext
from repro_torch.optim import adamw, cosine_with_warmup
from repro_torch.train.step import build_train_step, init_state

META = torch.device("meta")


# ---------------------------------------------------------------------------
# sharding helpers
# ---------------------------------------------------------------------------
def arch_rules(cfg: ArchConfig) -> Dict[str, Any]:
    return dict(DEFAULT_RULES, **dict(cfg.rules_override))


def batch_axes(mesh, cfg: Optional[ArchConfig] = None) -> Tuple[str, ...]:
    want = ("pod", "data")
    if cfg is not None:
        v = arch_rules(cfg).get("act_batch") or ()
        want = (v,) if isinstance(v, str) else tuple(v)
    names = mesh_extents(mesh)
    return tuple(a for a in want if a in names)


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    ext, n = mesh_extents(mesh), 1
    for a in axes:
        n *= ext[a]
    return n


def fit_spec(mesh, shape, *axes) -> Tuple[Any, ...]:
    """The placement of each dim: its axes degraded to the longest prefix
    that divides it (a tuple, or one name), or None where none divides
    (e.g. batch = 1)."""
    spec = []
    for dim, ax in zip(shape, axes):
        chosen = None
        if ax is not None:
            parts = (ax,) if isinstance(ax, str) else tuple(ax)
            for k in range(len(parts), 0, -1):
                if dim % _axis_size(mesh, parts[:k]) == 0:
                    chosen = parts[:k] if k > 1 else parts[0]
                    break
        spec.append(chosen)
    return tuple(spec)


def depth_cfg(cfg: ArchConfig, depth: Optional[int]) -> ArchConfig:
    """Reduce depth (keeping per-layer dims exact)."""
    if depth is None:
        return cfg
    kw: Dict[str, Any] = {"n_layers": depth, "force_unroll": True}
    if cfg.family == "encdec":
        kw.update(enc_layers=depth, dec_layers=depth, n_layers=2 * depth)
    if cfg.family == "moe" and cfg.moe.first_dense:
        kw["n_layers"] = depth + 1     # dense0 + `depth` MoE layers
    if cfg.family == "hybrid":
        kw["n_layers"] = depth * len(cfg.pattern)  # whole super-blocks
    return dataclasses.replace(cfg, **kw)


def scan_trips(cfg: ArchConfig) -> int:
    """Iterations of the (dominant) layer loop at full depth."""
    if cfg.family == "encdec":
        assert cfg.enc_layers == cfg.dec_layers
        return cfg.enc_layers
    if cfg.family == "moe" and cfg.moe.first_dense:
        return cfg.n_layers - 1
    if cfg.family == "hybrid":
        return cfg.n_layers // len(cfg.pattern)
    return cfg.n_layers


def exact_cfg(cfg: ArchConfig) -> ArchConfig:
    """Disable chunked attention (one query block per call)."""
    return dataclasses.replace(cfg, attn_chunk=1_000_000_000)


# ---------------------------------------------------------------------------
# batches and caches
# ---------------------------------------------------------------------------
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def train_batch_specs(cfg: ArchConfig, cell: ShapeCell, mesh):
    """(the global batch as meta tensors, each leaf's placement): the batch
    dim over the batch axes. The step takes the rank's rows itself."""
    b, s = cell.global_batch, cell.seq_len
    ba = batch_axes(mesh, cfg)
    if cfg.family == "encdec":
        sd = max(2, s // cfg.dec_ratio)
        batch = {"frames": _meta((b, s, cfg.d_model), torch.bfloat16),
                 "tokens": _meta((b, sd), torch.int32)}
        sh = {"frames": fit_spec(mesh, (b, s, cfg.d_model), ba, None, None),
              "tokens": fit_spec(mesh, (b, sd), ba, None)}
    elif cfg.modality == "vlm":
        batch = {"tokens": _meta((b, s), torch.int32),
                 "image_mask": _meta((b, s), torch.bool),
                 "image_embeds": _meta((b, s, cfg.d_model), torch.bfloat16)}
        sh = {"tokens": fit_spec(mesh, (b, s), ba, None),
              "image_mask": fit_spec(mesh, (b, s), ba, None),
              "image_embeds": fit_spec(mesh, (b, s, cfg.d_model), ba, None, None)}
    else:
        batch = {"tokens": _meta((b, s), torch.int32)}
        sh = {"tokens": fit_spec(mesh, (b, s), ba, None)}
    return batch, sh


def cache_shardings(mesh, caches, batch_size: int):
    """The reference's placement of each cache leaf, by key name and rank:
    the batch dim over ("pod", "data"), K/V's time axis over "model",
    recurrent state its widest dim. The port's ranks hold their block of
    the slots where the data axes divide them (``sharding.slot_sharding``:
    the cells build a rank's b/DP slots' caches, and a decode or prefill
    step runs its rows), of the K/V heads where the model axis divides
    them ("heads" architectures), or of a "seq" architecture 1/TP of the
    time rows where the model axis divides their length (interleaved:
    position p on the rank of index p mod TP, where the reference splits
    time in contiguous blocks; the bytes a rank holds are the same), and
    every recurrent carry whole over "model"; a paged pool (the engine's
    ``page_tokens`` cell) holds every slot's pages. The dry run reports
    this layout beside the bytes a rank holds (``cache_bytes``) and the
    time rows it holds (``cache_time_rows``)."""
    ba = batch_axes(mesh)

    def leaf(key, t):
        r = t.ndim
        if key in ("k", "v", "ck", "cv"):
            spec = [None] * (r - 4) + [ba, "model", None, None]
        elif key in ("ks", "vs"):
            spec = [None] * (r - 3) + [ba, "model", None]
        elif key == "h":
            spec = {2: [ba, "model"], 3: [None, ba, "model"],
                    4: [ba, "model", None, None]}.get(
                        r, [None, ba, "model", None, None])
        elif key == "conv":
            spec = [None] * (r - 3) + [ba, None, "model"]
        else:
            spec = [None] * r
        return fit_spec(mesh, t.shape, *spec)

    def rec(tree):
        if isinstance(tree, dict):
            return {k: leaf(k, v) if isinstance(v, torch.Tensor) else rec(v)
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [rec(v) for v in tree]
        return None

    return rec(caches)


def cache_time_rows(caches, path=()) -> Dict[str, int]:
    """{"/"-joined path: the time rows a rank holds} of every K/V leaf of a
    cache tree (``k`` / ``v`` / ``ck`` / ``cv`` (..., T, K, hd) and the
    int8 scales ``ks`` / ``vs`` (..., T, K)): a page's rows in a paged
    pool, a slot's in a dense cache or a ring."""
    out: Dict[str, int] = {}
    items = caches.items() if isinstance(caches, dict) else enumerate(caches)
    for key, v in items:
        if isinstance(v, torch.Tensor):
            if key in ("k", "v", "ck", "cv"):
                out["/".join(path + (str(key),))] = int(v.shape[-3])
            elif key in ("ks", "vs"):
                out["/".join(path + (str(key),))] = int(v.shape[-2])
        elif isinstance(v, (dict, list, tuple)):
            out.update(cache_time_rows(v, path + (str(key),)))
    return out


def tree_bytes(tree) -> int:
    """Bytes of every tensor in ``tree`` (nested dicts, lists, tuples)."""
    from torch.utils._pytree import tree_flatten

    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


# ---------------------------------------------------------------------------
# cell builders
# ---------------------------------------------------------------------------
def build_train_cell(cfg: ArchConfig, cell: ShapeCell, mesh):
    """One rank's fused train step (kernels B5 and B2 / B1, as the card
    trains) on its masters, AdamW moments and rows of the global batch."""
    ctx = ModelContext(policy=cfg.tbn, mode=TRAIN, device=META,
                       fused_train=True, fsdp_weights=cfg.fsdp_weights)
    model = build_model(cfg, ctx)
    specs = model.specs()
    shards = train_shards(specs, mesh, fsdp=cfg.fsdp_weights,
                          rules=dict(cfg.rules_override))
    params = place_train_params(mod.abstract_params(specs), shards, mesh)
    opt = adamw(cosine_with_warmup(3e-4, 100, 10_000), weight_decay=0.1)
    state = init_state(params, opt)
    batch, batch_sh = train_batch_specs(cfg, cell, mesh)
    step_fn = build_train_step(model.train_forward, opt,
                               grad_accum=cfg.grad_accum, mesh=mesh,
                               shards=shards, dp_axis=batch_axes(mesh, cfg))
    state_bytes = tree_bytes((state.params, state.opt_state))
    return dict(fn=step_fn, args=(state, batch), model=model,
                layouts=dict(batch=batch_sh),
                # the update is in place: the new state is the old one
                memory=dict(argument_bytes=state_bytes + tree_bytes(batch),
                            alias_bytes=state_bytes, state_bytes=state_bytes))


def _serve_model(cfg: ArchConfig):
    ctx = ModelContext(policy=cfg.tbn, mode=SERVE, param_dtype=torch.bfloat16,
                       compute_dtype=torch.bfloat16, device=META,
                       fsdp_weights=cfg.fsdp_weights)
    return build_model(cfg, ctx)


def _serve_params(cfg: ArchConfig, model, mesh):
    return place_params(mod.abstract_params(model.specs()), model.logical(),
                        mesh, dict(cfg.rules_override))


def build_prefill_cell(cfg: ArchConfig, cell: ShapeCell, mesh):
    """One rank's prefill of ``cell.global_batch`` prompts of
    ``cell.seq_len`` tokens: the step takes the whole batch and runs the
    rank's b/DP rows where the data axes divide b, its caches (the
    output) those rows'."""
    model = _serve_model(cfg)
    params = _serve_params(cfg, model, mesh)
    b, s = cell.global_batch, cell.seq_len
    ba = batch_axes(mesh, cfg)
    max_len = s  # serve cache sized to the cell's seq_len
    if cfg.family == "encdec":
        sd = max(2, s // cfg.dec_ratio)
        batch = {"frames": _meta((b, s, cfg.d_model), torch.bfloat16),
                 "tokens": _meta((b, sd), torch.int32)}
        batch_sh = {"frames": fit_spec(mesh, (b, s, cfg.d_model), ba, None, None),
                    "tokens": fit_spec(mesh, (b, sd), ba, None)}
        max_len = sd
    elif cfg.modality == "vlm":
        batch = {"tokens": _meta((b, s), torch.int32),
                 "image_mask": _meta((b, s), torch.bool),
                 "image_embeds": _meta((b, s, cfg.d_model), torch.bfloat16)}
        batch_sh = {"tokens": fit_spec(mesh, (b, s), ba, None),
                    "image_mask": fit_spec(mesh, (b, s), ba, None),
                    "image_embeds": fit_spec(mesh, (b, s, cfg.d_model), ba, None, None)}
    else:
        batch = {"tokens": _meta((b, s), torch.int32)}
        batch_sh = {"tokens": fit_spec(mesh, (b, s), ba, None)}

    @torch.no_grad()
    def prefill_fn(params, batch):
        return model.prefill(params, batch, max_len)

    return dict(fn=prefill_fn, args=(params, batch), model=model,
                layouts=dict(batch=batch_sh),
                memory=dict(argument_bytes=tree_bytes((params, batch)),
                            alias_bytes=0))


def build_decode_cell(cfg: ArchConfig, cell: ShapeCell, mesh,
                      page_tokens: Optional[int] = None):
    """One rank's decode step over ``cell.global_batch`` slots of
    ``cell.seq_len`` tokens: dense per-slot caches, or with
    ``page_tokens`` the engine's paged pool (b * ceil(s / page_tokens)
    pages and the scratch page, read through a page table; decoder LMs).
    The caches are built under the cell's rules, so they hold what the
    rank holds: its b/DP slots where the data axes divide b (the step takes
    every slot's tokens and runs the rank's rows), ``memory.cache_bytes``
    its bytes and ``memory.cache_time_rows`` the time rows of each K/V leaf
    (a "seq" architecture's 1/TP of them where the model axis divides
    them)."""
    model = _serve_model(cfg)
    params = _serve_params(cfg, model, mesh)
    b, s = cell.global_batch, cell.seq_len
    ba = batch_axes(mesh, cfg)
    page_table = None
    with axis_rules(mesh, dict(cfg.rules_override)):
        if cfg.family == "encdec":
            if page_tokens is not None:
                raise ValueError("a paged decode cell is built for decoder LMs")
            caches = _encdec_caches(model, cfg, b, s)
        elif page_tokens is not None:
            npp = -(-s // page_tokens)
            caches = model.init_caches(b, s, torch.bfloat16, page_tokens=page_tokens,
                                       n_pages=b * npp)
            page_table = _meta((b, npp), torch.int32)
        else:
            caches = model.init_caches(b, s, torch.bfloat16)
    tokens, lengths = _meta((b, 1), torch.int32), _meta((b,), torch.int32)
    # a decoder's caches' layout: a "seq" rank reads its rows by it
    layout = {} if cfg.family == "encdec" else dict(page_tokens=page_tokens, max_len=s)

    @torch.no_grad()
    def decode_fn(params, tokens, caches, lengths, page_table=None):
        return model.decode_step(params, tokens, caches, lengths, page_table, **layout)

    cache_bytes = tree_bytes(caches)
    args = (params, tokens, caches, lengths) + (
        () if page_table is None else (page_table,))
    return dict(fn=decode_fn, args=args,
                model=model,
                layouts=dict(tokens=fit_spec(mesh, (b, 1), ba, None),
                             caches=cache_shardings(mesh, caches, b)),
                # the decoder's caches update in place (the encdec dense
                # anchor returns new ones)
                memory=dict(argument_bytes=tree_bytes(args),
                            alias_bytes=0 if cfg.family == "encdec" else cache_bytes,
                            cache_bytes=cache_bytes,
                            cache_time_rows=cache_time_rows(caches)))


def _encdec_caches(model, cfg: ArchConfig, b: int, s: int):
    """Decoder self-cache (len s) + cross K/V over an encoder memory of len
    s: the dense anchor's rows, the rank's slots' under a slot split and
    the rank's block of the K/V heads under a head block (call under the
    cell's rules)."""
    attn = model.dec_block.self_attn
    block = slot_sharding(b)
    rows = b if block is None else b // block.extent
    shape = (cfg.dec_layers, rows, s, attn.kv_heads(), attn.hd)
    return {k: _meta(shape, torch.bfloat16) for k in ("k", "v", "ck", "cv")}


def build_cell(arch: str, shape: str, mesh):
    """One rank's part of the (arch x shape) cell under ``mesh``, at full
    depth (cut a config with ``depth_cfg`` and call a builder for less)."""
    cfg = get_config(arch)
    cell = SHAPES[shape]
    ok, reason = cell_applicable(cfg, cell)
    if not ok:
        raise ValueError(f"{arch} x {shape}: {reason}")
    builder = {
        "train": build_train_cell,
        "prefill": build_prefill_cell,
        "decode": build_decode_cell,
    }[cell.kind]
    return builder(cfg, cell, mesh)
