"""Decoder LM, dense, MoE, SSM and hybrid families: training and serving
entry points (port of the decoder-only paths of ``repro/models/lm.py``).

The layer stack is organised into segments, as in the reference: a
stacked segment holds ``n`` identical blocks whose params carry a leading
layer axis, and a Python loop walks its layers in place of ``lax.scan``;
an unstacked segment is one block without that axis (the MoE family's
``first_dense`` layer ``dense0``, the hybrid family's tails). The dense
family is one stacked segment of attention blocks; the MoE family a
stacked segment of MoE blocks, after ``dense0`` where the config asks for
it; the SSM family one stacked segment of mamba2 blocks (each the whole
layer, no FFN); the hybrid family a stacked segment of pattern
super-blocks (``_PatternBlock``: the cycle, e.g. rec, rec, attn, as one
unit whose cache is ``{"b0": ..., "b1": ..., ...}``), then one unstacked
tail block for each layer the cycles leave over.

Serving caches come in two families. Full attention pages its K/V through
the engine's pool (in the compute dtype, or int8 codes with f32 scales
where ``cfg.kv_dtype == "int8"``); a block writes the pool in place,
layer by layer, through views of the stacked leaves. Every other cache is
per slot, one row per slot: the SSM and RG-LRU ``(h, conv)`` carries, the
sliding-window ring ``(n_slots, min(max_len, window), K, hd)``, and the
dense ``(n_slots, max_len, K, hd)`` cache of a monolithic ``prefill``. A
block returns new per-slot tensors, and the layer walk copies them into
the held caches: all of them after ``extend``, the ``active`` slots'
rows after ``decode_step``. So every entry point writes the tensors the
caller holds, which the engine's captured graphs read and write.

Entry points: ``train_forward`` (next-token cross-entropy; each block is
checkpointed under ``cfg.remat == "full"``), ``prefill`` (the whole prompt
at once: the monolithic anchor that chunked prefill is held to),
``extend`` (chunked prefill of a (B, C) column block at per-slot offsets)
and ``decode_step`` (one token per slot), and the per-slot cache
operations the engine runs (``reset_slot_caches``, ``merge_caches``, the
snapshots).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.nn import module as mod
from repro_torch.nn.attention import Attention, _attend_core, make_mask, quantize_kv
from repro_torch.nn.context import ModelContext
from repro_torch.nn.embeddings import Embedding
from repro_torch.nn.ffn import MLP
from repro_torch.nn.linear import Dense
from repro_torch.nn.moe import MoE
from repro_torch.nn.norms import LayerNorm, RMSNorm
from repro_torch.nn.rglru import RGLRUBlock, _lru_scan
from repro_torch.nn.ssm import Mamba2Block

FAMILY_ITEM = ("ROADMAP.md queue A item 6 (the encoder-decoder and VLM "
               "families)")
FAMILIES = ("dense", "moe", "ssm", "hybrid")
DOTS_REMAT_ITEM = "ROADMAP.md queue A item 10 (leftovers: selective \"dots\" remat)"
# _ce_sum chunks the batch when b % 32 == 0 and S * vocab reaches this
CE_CHUNK_MIN_ELEMS = 2**26


def _norm(cfg: ArchConfig, ctx: ModelContext, dim: int, name: str):
    cls = RMSNorm if cfg.norm == "rmsnorm" else LayerNorm
    return cls(dim, ctx, name=name)


def _paged_attn(blk) -> bool:
    """Full-attention blocks page their K/V through the serving pool;
    windowed rings and recurrent state stay per slot."""
    return blk.kind == "attn" and not blk.cfg.window


def _map_block_cache(blk, fn, *subtrees):
    """``fn(leaf_block, *cache_subtrees)`` per leaf block, recursing through
    pattern super-blocks (whose cache is a {"b{i}": ...} dict)."""
    if blk.kind == "pattern":
        return {f"b{i}": _map_block_cache(b, fn, *(t[f"b{i}"] for t in subtrees))
                for i, b in enumerate(blk.blocks)}
    return fn(blk, *subtrees)


def _slot_mask(keep: torch.Tensor, v: torch.Tensor, axis: int) -> torch.Tensor:
    """``keep`` (n_slots,) shaped to broadcast along ``v``'s slot axis."""
    shape = [1] * v.ndim
    shape[axis] = keep.shape[0]
    return keep.reshape(shape)


def _store(held: dict, new: dict, keep=None, axis: int = 0) -> None:
    """Copy a block's new per-slot leaves into the held ones, in place:
    every slot, or the slots where ``keep`` is True. A leaf the block wrote
    in place (a paged pool) comes back as the held tensor and is skipped."""
    for name, h in held.items():
        n = new[name]
        if n is h:
            continue
        h.copy_(n if keep is None else torch.where(_slot_mask(keep, h, axis), n, h))


def _stack(trees: list):
    """Stack a list of equally keyed cache trees on a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


@dataclasses.dataclass
class Block:
    """One pre-norm residual block: (attn | rec | ssm) + (MLP | MoE); a
    mamba2 block is the whole layer (no FFN)."""

    cfg: ArchConfig
    ctx: ModelContext
    name: str = "block"
    use_moe: bool = False
    kind: str = "attn"              # "attn" | "rec" | "ssm"

    def __post_init__(self):
        cfg, ctx, d = self.cfg, self.ctx, self.cfg.d_model
        if cfg.kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"unknown kv_dtype {cfg.kv_dtype!r}")
        self.norm1 = _norm(cfg, ctx, d, f"{self.name}.norm1")
        if self.kind == "attn":
            self.mixer = Attention(
                d, cfg.n_heads, cfg.n_kv, ctx, head_dim=cfg.head_dim,
                name=f"{self.name}.attn", qkv_bias=cfg.qkv_bias,
                qk_norm=cfg.qk_norm, rope=cfg.rope_theta > 0,
                rope_theta=cfg.rope_theta or 10_000.0, q_chunk=cfg.attn_chunk,
                window=cfg.window,
            )
        elif self.kind == "rec":
            self.mixer = RGLRUBlock(d, ctx, name=f"{self.name}.rec")
        elif self.kind == "ssm":
            s = cfg.ssm
            self.mixer = Mamba2Block(
                d, ctx, d_state=s.d_state, head_dim=s.head_dim,
                expand=s.expand, n_groups=s.n_groups,
                conv_width=s.conv_width, chunk=s.chunk, name=f"{self.name}.ssm")
        else:
            raise ValueError(f"unknown block kind {self.kind!r}")
        self.has_ffn = self.kind != "ssm"
        if not self.has_ffn:
            return
        self.norm2 = _norm(cfg, ctx, d, f"{self.name}.norm2")
        if self.use_moe:
            m = cfg.moe
            self.ffn = MoE(d, m.d_ff_expert or cfg.d_ff, m.n_experts, m.top_k,
                           ctx, n_shared=m.n_shared, name=f"{self.name}.moe",
                           gated=cfg.gated_mlp, activation=cfg.activation)
        else:
            self.ffn = MLP(d, cfg.d_ff, ctx, name=f"{self.name}.mlp",
                           gated=cfg.gated_mlp, activation=cfg.activation)

    def specs(self) -> mod.SpecTree:
        out = {"norm1": self.norm1.specs(), "mixer": self.mixer.specs()}
        if self.has_ffn:
            out["norm2"] = self.norm2.specs()
            out["ffn"] = self.ffn.specs()
        return out

    def init_cache(self, batch: int, max_len: int, dtype, device,
                   page_tokens: Optional[int] = None,
                   n_pages: Optional[int] = None) -> dict:
        """Decode cache of one layer. Full attention with ``page_tokens``:
        the paged pool (n_pages + 1, page_tokens, K, hd), the extra page
        being the scratch target of dropped writes (nn/attention.py); under
        ``kv_dtype == "int8"`` int8 codes plus their per-token, per-head f32
        scales ``ks`` / ``vs``. Without ``page_tokens``: dense (batch,
        max_len, ...) slot rows. A windowed ring is (batch, min(max_len,
        window), K, hd) in ``dtype`` either way; SSM and RG-LRU layers get
        their f32 (h, conv) carries."""
        if self.kind != "attn":
            return self.mixer.init_state(batch, device=device)
        window = self.cfg.window
        if page_tokens is not None and not window:
            lead = (n_pages + 1, page_tokens, self.cfg.n_kv)
        else:
            lead = (batch, min(max_len, window) if window else max_len,
                    self.cfg.n_kv)
        shape = (*lead, self.mixer.hd)
        if self.cfg.kv_dtype == "int8" and not window:
            return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                    "v": torch.zeros(shape, dtype=torch.int8, device=device),
                    "ks": torch.zeros(lead, dtype=torch.float32, device=device),
                    "vs": torch.zeros(lead, dtype=torch.float32, device=device)}
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def _ffn(self, params, x):
        """x + FFN(norm2(x)) and the FFN's aux loss (an MoE's load-balance
        term; None for an MLP or a block without FFN)."""
        if not self.has_ffn:
            return x, None
        h = self.norm2(params["norm2"], x)
        if self.use_moe:
            h, aux = self.ffn(params["ffn"], h)
            return x + h, aux
        return x + self.ffn(params["ffn"], h), None

    def __call__(self, params, x, *, positions=None):
        """Training forward of one block: x (B, S, d) -> ((B, S, d), aux)."""
        h = self.norm1(params["norm1"], x)
        if self.kind == "attn":
            h = self.mixer(params["mixer"], h, positions=positions)
        else:
            h = self.mixer(params["mixer"], h)
        return self._ffn(params, x + h)

    # ---------------- serving ----------------
    def prefill(self, params, x, *, positions=None):
        """Forward over the whole prompt -> (x, this layer's cache): the
        prompt's K/V (quantized under int8 K/V), or the recurrent carry
        after the last token."""
        h = self.norm1(params["norm1"], x)
        if self.kind == "attn":
            h, (k, v) = self.mixer.prefill(params["mixer"], h, positions)
            if self.cfg.kv_dtype == "int8" and not self.cfg.window:
                kq, ks = quantize_kv(k)
                vq, vs = quantize_kv(v)
                cache = {"k": kq, "v": vq, "ks": ks, "vs": vs}
            else:
                cache = {"k": k, "v": v}
        elif self.kind == "ssm":
            h, cache = self.mixer.forward_with_state(params["mixer"], h)
        else:
            cache = self._rec_final_state(params["mixer"], h)
            h = self.mixer(params["mixer"], h)
        return self._ffn(params, x + h)[0], cache

    def _rec_final_state(self, params, h):
        """RG-LRU final (h, conv window) after a prefill pass: the last scan
        state and the last w - 1 inputs of the conv (in the compute dtype,
        zero-padded in front of a shorter prompt)."""
        mixer: RGLRUBlock = self.mixer
        xin = mixer.in_x(params["in_x"], h)
        a, b = mixer._gates(params, mixer._conv(params, xin))
        tail = xin[:, -(mixer.conv_width - 1):, :]
        pad = mixer.conv_width - 1 - tail.shape[1]
        if pad > 0:
            tail = torch.nn.functional.pad(tail, (0, 0, pad, 0))
        return {"h": _lru_scan(a, b)[:, -1], "conv": tail}

    def decode_step(self, params, x, cache, *, lengths, page_table=None,
                    active=None):
        """One token per slot. Paged pools are written in place (inactive
        slots drop their write); the per-slot families come back as new
        tensors for the caller to store."""
        h = self.norm1(params["norm1"], x)
        if self.kind != "attn":
            h, cache = self.mixer.decode_step(params["mixer"], h, cache)
        elif self.cfg.window:
            h, cache = self._windowed_decode(params["mixer"], h, cache, lengths)
        elif "ks" in cache:
            h, cache = self.mixer.decode_step_quant(
                params["mixer"], h, cache, lengths, page_table, active=active)
        else:
            h, ck, cv = self.mixer.decode_step(
                params["mixer"], h, cache["k"], cache["v"], lengths,
                page_table, active=active)
            cache = {"k": ck, "v": cv}
        return self._ffn(params, x + h)[0], cache

    def extend(self, params, x, cache, *, positions, valid, page_table=None):
        """Advance a (B, C) column block at per-slot offsets (chunked
        prefill). ``valid`` (B, C), a prefix of each row, marks the real
        columns: padding never writes a cache row and never advances a
        carry, so a slot moves by exactly its count of valid columns."""
        h = self.norm1(params["norm1"], x)
        if self.kind != "attn":
            h, cache = self.mixer.extend(params["mixer"], h, cache, valid)
        elif self.cfg.window:
            h, cache = self._windowed_extend(params["mixer"], h, cache,
                                             positions, valid)
        elif "ks" in cache:
            h, cache = self.mixer.extend_quant(
                params["mixer"], h, cache, positions, valid, page_table)
        else:
            h, ck, cv = self.mixer.extend(
                params["mixer"], h, cache["k"], cache["v"], positions, valid,
                page_table)
            cache = {"k": ck, "v": cv}
        return self._ffn(params, x + h)[0], cache

    def _windowed_extend(self, params, x, cache, positions, valid):
        """Chunked prefill against the sliding-window ring (B, t, K, hd).

        A column's write evicts the ring entry ``t`` positions back, which
        earlier columns of the same chunk may still need, so the queries
        attend [old ring ; this chunk's fresh K/V] and the ring is updated
        afterwards. Each ring row takes the last valid column of its residue
        class mod t (columns >= n_new - t), if any, and keeps its entry
        otherwise. The reference drops the other columns' writes through an
        out-of-range scatter index; here each ring row gathers its writer
        and selects, so nothing is scattered and nothing reads the host."""
        mixer: Attention = self.mixer
        b, c, _ = x.shape
        t = cache["k"].shape[1]
        window = self.cfg.window or t + 1
        q, k, v = mixer._qkv(params, x, positions)
        # old-ring key positions from the pre-chunk frontier: ring row j
        # holds the largest written position p <= lengths - 1 with p = j (t)
        lengths = positions[:, :1]
        ring = torch.arange(t, device=x.device)[None, :]
        k_pos_old = lengths - 1 - torch.remainder(lengths - 1 - ring, t)
        dt = cache["k"].dtype
        k_cat = torch.cat([cache["k"], k.to(dt)], dim=1)
        v_cat = torch.cat([cache["v"], v.to(dt)], dim=1)
        mask = torch.cat([
            make_mask(positions, k_pos_old, causal=True, window=window,
                      k_valid=k_pos_old >= 0),
            make_mask(positions, positions, causal=True, window=window,
                      k_valid=valid)], dim=-1)
        out = _attend_core(mixer._group(q), k_cat, v_cat, mask,
                           1.0 / math.sqrt(mixer.hd))
        y = mixer.wo(params["wo"], out.reshape(b, c, mixer.n_heads * mixer.hd))
        # ring row j's writer: the column in [lo, lo + t) whose position is
        # j mod t, lo = max(n_new - t, 0); it writes when it is valid
        n_new = valid.sum(dim=1, keepdim=True)
        lo = (n_new - t).clamp_min(0)
        col = lo + torch.remainder(ring - lengths - lo, t)         # (B, t)
        hit = (col < n_new)[:, :, None, None]
        src = col.clamp_max(c - 1)[:, :, None, None].expand(b, t, *k.shape[2:])
        ck = torch.where(hit, torch.gather(k, 1, src).to(dt), cache["k"])
        cv = torch.where(hit, torch.gather(v, 1, src).to(dt), cache["v"])
        return y, {"k": ck, "v": cv}

    def _windowed_decode(self, params, x, cache, lengths):
        """Sliding-window decode against the ring (B, t, K, hd), t <= W.
        Invariant: ring row j holds the K/V of the largest position p <=
        lengths with p = j (mod t). Every slot writes its row at lengths
        mod t into new ring tensors, which are returned."""
        mixer: Attention = self.mixer
        b = x.shape[0]
        t = cache["k"].shape[1]
        q, k, v = mixer._qkv(params, x, lengths[:, None])
        idx = torch.arange(b, device=x.device)
        slot = torch.remainder(lengths, t).long()
        ck, cv = cache["k"].clone(), cache["v"].clone()
        ck[idx, slot] = k[:, 0].to(ck.dtype)
        cv[idx, slot] = v[:, 0].to(cv.dtype)
        ring = torch.arange(t, device=x.device)[None, :]
        k_pos = lengths[:, None] - torch.remainder(lengths[:, None] - ring, t)
        ok = (k_pos >= 0) & (lengths[:, None] - k_pos < (self.cfg.window or t + 1))
        out = _attend_core(mixer._group(q), ck, cv, ok[:, None, :],
                           1.0 / math.sqrt(mixer.hd))
        y = mixer.wo(params["wo"], out.reshape(b, 1, mixer.n_heads * mixer.hd))
        return y, {"k": ck, "v": cv}


@dataclasses.dataclass
class _PatternBlock:
    """Super-block: the hybrid cycle (e.g. rec, rec, attn) as one unit."""

    cfg: ArchConfig
    ctx: ModelContext
    pattern: Tuple[str, ...]
    name: str = "pattern"

    def __post_init__(self):
        self.blocks = [Block(self.cfg, self.ctx, name=f"{self.name}.{i}_{kind}",
                             kind=kind)
                       for i, kind in enumerate(self.pattern)]
        self.kind = "pattern"

    def specs(self) -> mod.SpecTree:
        return {f"b{i}": b.specs() for i, b in enumerate(self.blocks)}

    def __call__(self, params, x, *, positions=None):
        for i, b in enumerate(self.blocks):
            x, _ = b(params[f"b{i}"], x, positions=positions)
        return x, None

    def init_cache(self, batch, max_len, dtype, device, page_tokens=None,
                   n_pages=None):
        return {f"b{i}": b.init_cache(batch, max_len, dtype, device,
                                      page_tokens, n_pages)
                for i, b in enumerate(self.blocks)}

    def _forward(self, method, params, x, cache, **kw):
        """Thread the residual stream through each sub-block's ``method``,
        collecting their caches under the ``b{i}`` keys; ``cache`` None
        (prefill) means each sub-block builds its cache."""
        out = {}
        for i, b in enumerate(self.blocks):
            args = (x,) if cache is None else (x, cache[f"b{i}"])
            x, out[f"b{i}"] = getattr(b, method)(params[f"b{i}"], *args, **kw)
        return x, out

    def prefill(self, params, x, *, positions=None):
        return self._forward("prefill", params, x, None, positions=positions)

    def decode_step(self, params, x, cache, *, lengths, page_table=None,
                    active=None):
        return self._forward("decode_step", params, x, cache, lengths=lengths,
                             page_table=page_table, active=active)

    def extend(self, params, x, cache, *, positions, valid, page_table=None):
        return self._forward("extend", params, x, cache, positions=positions,
                             valid=valid, page_table=page_table)


@dataclasses.dataclass
class Segment:
    """A stack of ``n`` identical blocks with layer-stacked params, or one
    unstacked block (``scanned`` False: params and caches without the
    layer axis)."""

    block: Block
    n: int
    scanned: bool = True

    def specs(self) -> mod.SpecTree:
        s = self.block.specs()
        return mod.stack_specs(s, self.n) if self.scanned else s

    def layers(self, tree):
        """The per-layer views of a param or cache tree of this segment."""
        if not self.scanned:
            return [tree]
        return [mod.map_tree(lambda v, j=j: v[j], tree) for j in range(self.n)]


class DecoderLM:
    def __init__(self, cfg: ArchConfig, ctx: Optional[ModelContext] = None):
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"model family {cfg.family!r} is not ported yet: {FAMILY_ITEM}")
        self.cfg = cfg
        self.ctx = ctx or ModelContext(policy=cfg.tbn)
        c = self.ctx
        self.embed = Embedding(cfg.vocab, cfg.d_model, c, name="embed")
        self.segments: List[Segment] = self._build_segments()
        self.final_norm = _norm(cfg, c, cfg.d_model, "final_norm")
        if not cfg.tie_embeddings:
            self.head = Dense(cfg.d_model, cfg.vocab, c, name="lm_head",
                              kind="head")

    def _build_segments(self) -> List[Segment]:
        cfg, c = self.cfg, self.ctx
        if cfg.family == "dense":
            return [Segment(Block(cfg, c, name="block"), cfg.n_layers)]
        if cfg.family == "ssm":
            return [Segment(Block(cfg, c, name="ssm_block", kind="ssm"),
                            cfg.n_layers)]
        if cfg.family == "hybrid":
            pat = cfg.pattern
            full, rem = divmod(cfg.n_layers, len(pat))
            segs = [Segment(_PatternBlock(cfg, c, pat, name="hybrid"), full)]
            segs += [Segment(Block(cfg, c, name=f"tail{i}", kind=pat[i]), 1,
                             scanned=False) for i in range(rem)]
            return segs
        segs, n = [], cfg.n_layers
        if cfg.moe.first_dense:
            segs.append(Segment(Block(cfg, c, name="dense0"), 1, scanned=False))
            n -= 1
        segs.append(Segment(Block(cfg, c, name="moe_block", use_moe=True), n))
        return segs

    @property
    def device(self) -> torch.device:
        return self.ctx.device

    def specs(self) -> mod.SpecTree:
        out = {"embed": self.embed.specs(),
               "final_norm": self.final_norm.specs()}
        for i, seg in enumerate(self.segments):
            out[f"seg{i}"] = seg.specs()
        if not self.cfg.tie_embeddings:
            out["head"] = self.head.specs()
        return out

    def init(self, seed: int) -> dict:
        return mod.init_params(self.specs(), seed, self.device)

    def logits(self, params, h) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return self.embed.attend(params["embed"], h)
        return self.head(params["head"], h)

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def _remat_call(self, block, pl, x, positions):
        if self.cfg.remat == "none":
            return block(pl, x, positions=positions)
        if self.cfg.remat == "dots":
            raise NotImplementedError(
                f"remat='dots' is not ported yet: {DOTS_REMAT_ITEM}")
        if self.cfg.remat != "full":
            raise ValueError(f"unknown remat {self.cfg.remat!r}")
        return checkpoint(lambda h: block(pl, h, positions=positions), x,
                          use_reentrant=False)

    def backbone(self, params, x, *, positions=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Blocks, then the final norm -> (h, aux): aux sums the MoE layers'
        load-balance terms (0 for the dense family). Each stacked leaf is
        unbound into its layers, so the layers' gradients stack back into
        the leaf."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, seg in enumerate(self.segments):
            p = params[f"seg{i}"]
            if seg.scanned:
                p = mod.map_tree(lambda v: v.unbind(0), p)
            for pl in seg.layers(p):
                x, a = self._remat_call(seg.block, pl, x, positions)
                if a is not None:
                    aux = aux + a
        return self.final_norm(params["final_norm"], x), aux

    def train_forward(self, params, batch) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Next-token CE loss. batch: tokens (B, S) [+ loss_mask (B, S)],
        moved to the model's device here."""
        tokens = batch["tokens"].to(self.device).long()
        b, s = tokens.shape
        positions = torch.arange(s, device=self.device).expand(b, s)
        x = self.embed(params["embed"], tokens)
        h, aux = self.backbone(params, x, positions=positions)
        # full-sequence logits; the shifted last position is masked out
        targets = torch.roll(tokens, -1, dims=1)
        valid = (torch.arange(s, device=self.device) < s - 1).float()[None, :]
        mask = batch.get("loss_mask")
        mask = valid if mask is None else mask.to(self.device).float() * valid
        mask = mask.expand(b, s)
        ce = self._ce_sum(params, h, targets, mask) / mask.sum().clamp_min(1.0)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    def _ce_sum(self, params, h, targets, mask) -> torch.Tensor:
        """Summed token NLL. Batch-chunked, each chunk checkpointed, when the
        (B, S, V) f32 logits would be large: the backward then recomputes
        one sub-batch's logits at a time."""
        b = h.shape[0]
        big = h.shape[1] * self.cfg.vocab >= CE_CHUNK_MIN_ELEMS
        nb = b // 32 if (b % 32 == 0 and big) else 1
        if nb <= 1:
            return self._ce_sum_chunk(params, h, targets, mask)
        tot = torch.zeros((), dtype=torch.float32, device=h.device)
        for hc, tc, mc in zip(h.chunk(nb), targets.chunk(nb), mask.chunk(nb)):
            tot = tot + checkpoint(self._ce_sum_chunk, params, hc, tc, mc,
                                   use_reentrant=False)
        return tot

    def _ce_sum_chunk(self, params, h, targets, mask) -> torch.Tensor:
        logits = self.logits(params, h).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[..., None])[..., 0]
        return ((logz - gold) * mask).sum()

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    def init_caches(self, batch: int, max_len: int, dtype,
                    page_tokens: Optional[int] = None,
                    n_pages: Optional[int] = None) -> list:
        """Decode caches for ``batch`` slots, one tree per segment (see
        ``Block.init_cache``), each leaf with a leading layer axis in a
        stacked segment, e.g. {"k", "v"} (n_layers, n_pages + 1,
        page_tokens, K, hd). With ``page_tokens`` / ``n_pages`` full
        attention takes the paged pool (one page index space for every
        layer, addressed by the engine's one page table); windowed rings
        and recurrent carries are per slot either way."""
        caches = []
        for seg in self.segments:
            c = seg.block.init_cache(batch, max_len, dtype, self.device,
                                     page_tokens, n_pages)
            if seg.scanned:
                c = mod.map_tree(
                    lambda v: v[None].repeat(seg.n, *([1] * v.ndim)), c)
            caches.append(c)
        return caches

    # ---- per-slot cache families ----
    def _leaf_blocks(self):
        for seg in self.segments:
            blk = seg.block
            yield from (blk.blocks if blk.kind == "pattern" else [blk])

    @property
    def has_full_attn(self) -> bool:
        """Any full-attention layer: the engine stands up a page pool."""
        return any(_paged_attn(b) for b in self._leaf_blocks())

    @property
    def has_recurrent_state(self) -> bool:
        """Any cache that cannot be paged (SSM / RG-LRU carries, windowed
        rings): admission must zero the slot's rows."""
        return any(not _paged_attn(b) for b in self._leaf_blocks())

    def _per_slot(self, caches, fn, *others):
        """``fn(leaf_block, cache subtree, *other subtrees, slot_axis)`` over
        every segment's leaf blocks -> the list of results."""
        out = []
        for i, seg in enumerate(self.segments):
            ax = 1 if seg.scanned else 0
            out.append(_map_block_cache(
                seg.block, lambda blk, *t, ax=ax: fn(blk, *t, ax),
                caches[i], *(o[i] for o in others)))
        return out

    def reset_slot_caches(self, caches, slot, paged: bool = False):
        """Zero one slot's rows of the per-slot families, in place: SSM and
        RG-LRU carries must restart from zeros (extend continues from the
        slot's carry); windowed rings are cleared too. With ``paged`` the
        pool leaves are left alone: their pages are about to be remapped
        and stale rows are position-masked. ``slot`` is an int or a 0-d
        index tensor (the engine's captured reset reads one); a slot outside
        [0, n_slots) zeroes nothing."""
        def per_block(blk, ct, ax):
            if paged and _paged_attn(blk):
                return ct
            for v in ct.values():
                n = v.shape[ax]
                hit = torch.arange(n, device=v.device) == slot
                v.masked_fill_(_slot_mask(hit, v, ax), 0)
            return ct

        self._per_slot(caches, per_block)
        return caches

    def snapshot_slot_caches(self, caches, slot: int):
        """One slot's per-slot cache state as a standalone tree: SSM and
        RG-LRU carries (the mixers' ``snapshot_state``) and windowed ring
        rows; full-attention entries are None (their prefix lives in pool
        pages)."""
        def per_block(blk, ct, ax):
            if blk.kind in ("rec", "ssm"):
                return blk.mixer.snapshot_state(ct, slot, axis=ax)
            if blk.kind == "attn" and blk.cfg.window:
                return mod.slice_slot_rows(ct, slot, ax)
            return None

        return self._per_slot(caches, per_block)

    def restore_slot_caches(self, caches, slot: int, snaps):
        """Write a snapshot back into a slot's rows, in place; None entries
        (full attention) pass through."""
        def per_block(blk, ct, st, ax):
            if st is None:
                return ct
            if blk.kind in ("rec", "ssm"):
                return blk.mixer.restore_state(ct, slot, st, axis=ax)
            return mod.set_slot_rows(ct, slot, st, ax)

        return self._per_slot(caches, per_block, snaps)

    def merge_caches(self, old, new, keep, paged: bool = False):
        """Per-slot cache select, written into ``old`` in place: the rows
        where ``keep`` (B,) is True take ``new``, the others keep ``old``.
        With ``paged`` a paged pool is taken wholesale (its writes were
        confined in place by ``active``). A leaf that ``new`` shares with
        ``old`` (an entry point already wrote it) is left as it is."""
        def per_block(blk, ot, nt, ax):
            if paged and _paged_attn(blk):
                _store(ot, nt)
            else:
                _store(ot, nt, keep, ax)
            return ot

        self._per_slot(old, per_block, new)
        return old

    # ---- entry points ----
    def prefill(self, params, batch, max_len: int):
        """Run the whole prompt at once -> (last-position logits (B, vocab),
        caches, lengths). The caches are per slot: full attention's K/V
        padded to ``max_len`` (the dense form ``decode_step`` takes with
        ``page_table`` None), rings laid out so row j holds position p = j
        (mod t), and the recurrent carries."""
        tokens = batch["tokens"].to(self.device).long()
        b, s = tokens.shape
        positions = torch.arange(s, device=self.device).expand(b, s)
        x = self.embed(params["embed"], tokens)
        caches = []
        for i, seg in enumerate(self.segments):
            per_layer = []
            for pl in seg.layers(params[f"seg{i}"]):
                x, cl = seg.block.prefill(pl, x, positions=positions)
                per_layer.append(cl)
            cache = _stack(per_layer) if seg.scanned else per_layer[0]
            caches.append(self._pad_cache(seg, cache, max_len, s))
        h = self.final_norm(params["final_norm"], x[:, -1:])
        lengths = torch.full((b,), s, dtype=torch.int32, device=self.device)
        return self.logits(params, h)[:, 0], caches, lengths

    def _pad_cache(self, seg, cache, max_len: int, prompt_len: int):
        """Grow attention caches to serving size: zero rows up to max_len,
        or for a window ring t = min(max_len, window) the last t entries,
        rolled so that row j holds position p = j (mod t)."""
        window = self.cfg.window
        ax = 2 if seg.scanned else 1
        target = min(max_len, window) if window else max_len

        def pad_kv(v):
            t = v.shape[ax]
            if t > target:
                v = torch.roll(v.narrow(ax, t - target, target),
                               prompt_len % target, dims=ax)
            elif t < target:
                shape = list(v.shape)
                shape[ax] = target - t
                v = torch.cat([v, v.new_zeros(shape)], dim=ax)
            return v

        def rec(c):
            if "k" in c and "v" in c:
                return {name: pad_kv(v) for name, v in c.items()}
            return {k: rec(v) if isinstance(v, dict) else v
                    for k, v in c.items()}

        return rec(cache)

    def _walk_segments(self, params, x, caches, step_fn, keep=None):
        """Apply ``step_fn(block, layer_params, x, layer_cache)`` layer by
        layer and store each layer's new per-slot leaves into the held
        caches (all slots, or the ``keep`` ones). Layer params and caches
        are views into the stacked leaves, so every write lands in the
        caller's tensors."""
        for i, seg in enumerate(self.segments):
            for pl, cl in zip(seg.layers(params[f"seg{i}"]),
                              seg.layers(caches[i])):
                x, new = step_fn(seg.block, pl, x, cl)
                _map_block_cache(
                    seg.block, lambda blk, h, n: _store(h, n, keep), cl, new)
        return x, caches

    def decode_step(self, params, tokens, caches, lengths, page_table=None,
                    active=None):
        """tokens (B, 1) -> (logits (B, vocab), caches, lengths + 1). With
        ``page_table`` full attention reads and writes the paged pools,
        without it the dense slot rows of a monolithic prefill. ``active``
        (B,) confines every cache write to the live slots: pool writes of
        the others are dropped and their per-slot rows are left as they
        were (the reference leaves the latter to ``merge_caches``)."""
        x = self.embed(params["embed"], tokens)
        x, caches = self._walk_segments(
            params, x, caches,
            lambda blk, pl, h, cl: blk.decode_step(
                pl, h, cl, lengths=lengths, page_table=page_table,
                active=active),
            keep=active)
        h = self.final_norm(params["final_norm"], x)
        return self.logits(params, h)[:, 0], caches, lengths + 1

    def extend(self, params, tokens, caches, lengths, n_new, page_table=None):
        """Chunked-prefill step: advance each slot by its next n_new[b]
        prompt tokens. tokens (B, C); columns >= n_new[b] are padding.
        Returns (logits at each slot's last valid column (B, vocab), caches,
        lengths + n_new); a slot with n_new == 0 is untouched and its
        logits row is meaningless."""
        b, c = tokens.shape
        cols = torch.arange(c, device=tokens.device)[None, :]
        positions = lengths[:, None] + cols
        valid = cols < n_new[:, None]
        x = self.embed(params["embed"], tokens)
        x, caches = self._walk_segments(
            params, x, caches,
            lambda blk, pl, h, cl: blk.extend(
                pl, h, cl, positions=positions, valid=valid,
                page_table=page_table))
        idx = (n_new.long() - 1).clamp(0, c - 1)
        h_last = torch.gather(x, 1, idx[:, None, None].expand(b, 1, x.shape[-1]))
        h = self.final_norm(params["final_norm"], h_last)
        return self.logits(params, h)[:, 0], caches, lengths + n_new
