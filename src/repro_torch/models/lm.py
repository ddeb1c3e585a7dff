"""Decoder LM, dense family, serving entry points (port of the dense-family
serve path of ``repro/models/lm.py``).

The layer stack is one segment of ``n_layers`` identical blocks whose
params are stacked on a leading layer axis (``seg0``), as in the
reference; a Python loop walks the layers in place of ``lax.scan``. The
paged K/V pool of each segment is stacked the same way and updated in
place, layer by layer, through views.

Entry points: ``extend`` (chunked prefill of a (B, C) column block at
per-slot offsets) and ``decode_step`` (one token per slot). Training,
monolithic prefill, windowed rings, int8 KV and the other families wait
for later slices.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.nn import module as mod
from repro_torch.nn.attention import Attention
from repro_torch.nn.context import ModelContext
from repro_torch.nn.embeddings import Embedding
from repro_torch.nn.ffn import MLP
from repro_torch.nn.linear import Dense
from repro_torch.nn.norms import LayerNorm, RMSNorm

FAMILY_ITEM = "ROADMAP.md queue A item 10 (the other model families)"
WINDOW_ITEM = "ROADMAP.md queue A item 10 (windowed rings, recurrent state)"
INT8_KV_ITEM = "ROADMAP.md queue A item 7 (integer paths, int8 KV)"


def _norm(cfg: ArchConfig, ctx: ModelContext, dim: int, name: str):
    cls = RMSNorm if cfg.norm == "rmsnorm" else LayerNorm
    return cls(dim, ctx, name=name)


@dataclasses.dataclass
class Block:
    """One pre-norm residual block: full attention + MLP."""

    cfg: ArchConfig
    ctx: ModelContext
    name: str = "block"

    def __post_init__(self):
        cfg, ctx, d = self.cfg, self.ctx, self.cfg.d_model
        if cfg.window:
            raise NotImplementedError(
                f"sliding-window attention is not ported yet: {WINDOW_ITEM}")
        if cfg.kv_dtype != "bf16":
            raise NotImplementedError(
                f"kv_dtype {cfg.kv_dtype!r} is not ported yet: {INT8_KV_ITEM}")
        self.norm1 = _norm(cfg, ctx, d, f"{self.name}.norm1")
        self.mixer = Attention(
            d, cfg.n_heads, cfg.n_kv, ctx, head_dim=cfg.head_dim,
            name=f"{self.name}.attn", qkv_bias=cfg.qkv_bias,
            qk_norm=cfg.qk_norm, rope=cfg.rope_theta > 0,
            rope_theta=cfg.rope_theta or 10_000.0,
        )
        self.norm2 = _norm(cfg, ctx, d, f"{self.name}.norm2")
        self.ffn = MLP(d, cfg.d_ff, ctx, name=f"{self.name}.mlp",
                       gated=cfg.gated_mlp, activation=cfg.activation)

    def specs(self) -> mod.SpecTree:
        return {"norm1": self.norm1.specs(), "mixer": self.mixer.specs(),
                "norm2": self.norm2.specs(), "ffn": self.ffn.specs()}

    def init_cache(self, n_pages: int, page_tokens: int, dtype, device) -> dict:
        """Paged K/V pool: (n_pages + 1, page_tokens, K, hd), the extra page
        being the scratch target of dropped writes (nn/attention.py)."""
        shape = (n_pages + 1, page_tokens, self.cfg.n_kv, self.mixer.hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def _ffn(self, params, x):
        return x + self.ffn(params["ffn"], self.norm2(params["norm2"], x))

    def decode_step(self, params, x, cache, *, lengths, page_table, active=None):
        h = self.norm1(params["norm1"], x)
        h, ck, cv = self.mixer.decode_step(
            params["mixer"], h, cache["k"], cache["v"], lengths,
            page_table, active=active)
        return self._ffn(params, x + h), {"k": ck, "v": cv}

    def extend(self, params, x, cache, *, positions, valid, page_table):
        h = self.norm1(params["norm1"], x)
        h, ck, cv = self.mixer.extend(
            params["mixer"], h, cache["k"], cache["v"], positions, valid,
            page_table)
        return self._ffn(params, x + h), {"k": ck, "v": cv}


@dataclasses.dataclass
class Segment:
    """A stack of ``n`` identical blocks with layer-stacked params."""

    block: Block
    n: int

    def specs(self) -> mod.SpecTree:
        return mod.stack_specs(self.block.specs(), self.n)


class DecoderLM:
    def __init__(self, cfg: ArchConfig, ctx: Optional[ModelContext] = None):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"model family {cfg.family!r} is not ported yet: {FAMILY_ITEM}")
        self.cfg = cfg
        self.ctx = ctx or ModelContext(policy=cfg.tbn)
        c = self.ctx
        self.embed = Embedding(cfg.vocab, cfg.d_model, c, name="embed")
        self.segments: List[Segment] = [
            Segment(Block(cfg, c, name="block"), cfg.n_layers)]
        self.final_norm = _norm(cfg, c, cfg.d_model, "final_norm")
        if not cfg.tie_embeddings:
            self.head = Dense(cfg.d_model, cfg.vocab, c, name="lm_head",
                              kind="head")

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
    # serving
    # ------------------------------------------------------------------
    def init_caches(self, n_pages: int, page_tokens: int, dtype) -> list:
        """One stacked paged pool per segment: {"k", "v"} each
        (n_layers, n_pages + 1, page_tokens, K, hd)."""
        caches = []
        for seg in self.segments:
            c = seg.block.init_cache(n_pages, page_tokens, dtype, self.device)
            caches.append({k: v[None].repeat(seg.n, *([1] * v.ndim))
                           for k, v in c.items()})
        return caches

    def _walk_segments(self, params, x, caches, step_fn):
        """Apply ``step_fn(block, layer_params, x, layer_cache)`` layer by
        layer. Layer params and caches are views into the stacked leaves,
        so the in-place pool writes land in the stacked cache."""
        for i, seg in enumerate(self.segments):
            p, cache = params[f"seg{i}"], caches[i]
            for j in range(seg.n):
                pl = mod.map_tree(lambda v, j=j: v[j], p)
                cl = {name: leaf[j] for name, leaf in cache.items()}
                x, _ = step_fn(seg.block, pl, x, cl)
        return x, caches

    def decode_step(self, params, tokens, caches, lengths, page_table,
                    active=None):
        """tokens (B, 1) -> (logits (B, vocab), caches, lengths + 1). Pool
        writes are confined to ``active`` slots (B,) when given."""
        x = self.embed(params["embed"], tokens)
        x, caches = self._walk_segments(
            params, x, caches,
            lambda blk, pl, h, cl: blk.decode_step(
                pl, h, cl, lengths=lengths, page_table=page_table,
                active=active))
        h = self.final_norm(params["final_norm"], x)
        return self.logits(params, h)[:, 0], caches, lengths + 1

    def extend(self, params, tokens, caches, lengths, n_new, page_table):
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

    def merge_caches(self, old, new, keep, paged: bool = True):
        """Per-slot cache select. Every cache of this model is a paged pool
        whose writes were already confined by ``active``, so the new pools
        are taken wholesale (the reference's ``paged=True`` branch)."""
        if not paged:
            raise NotImplementedError("dense per-slot caches are not ported")
        return new

    def reset_slot_caches(self, caches, slot, paged: bool = True):
        """Paged pool leaves are left alone on admission: their pages are
        about to be remapped and stale rows are position-masked."""
        if not paged:
            raise NotImplementedError("dense per-slot caches are not ported")
        return caches
