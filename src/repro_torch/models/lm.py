"""Decoder LM, dense and MoE families: training and serving entry points
(port of the dense- and MoE-family paths of ``repro/models/lm.py``).

The layer stack is organised into segments, as in the reference: a
stacked segment holds ``n`` identical blocks whose params carry a leading
layer axis, and a Python loop walks its layers in place of ``lax.scan``;
an unstacked segment is one block without that axis (the MoE family's
``first_dense`` layer, ``dense0``). The dense family is one stacked
segment of ``n_layers`` blocks (``seg0``); the MoE family is a stacked
segment of MoE blocks, after ``dense0`` where the config asks for it. The
paged K/V pool of each segment has the same layout and is updated in
place, layer by layer, through views.

Entry points: ``train_forward`` (next-token cross-entropy; each block is
checkpointed under ``cfg.remat == "full"``), ``extend`` (chunked prefill
of a (B, C) column block at per-slot offsets) and ``decode_step`` (one
token per slot). The K/V pool is in the compute dtype, or int8 codes with
f32 scales where ``cfg.kv_dtype == "int8"``. Monolithic prefill, windowed
rings and the other families wait for later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.nn import module as mod
from repro_torch.nn.attention import Attention
from repro_torch.nn.context import ModelContext
from repro_torch.nn.embeddings import Embedding
from repro_torch.nn.ffn import MLP
from repro_torch.nn.linear import Dense
from repro_torch.nn.moe import MoE
from repro_torch.nn.norms import LayerNorm, RMSNorm

FAMILY_ITEM = ("ROADMAP.md queue A items 5-6 (the SSM/hybrid and "
               "encoder-decoder/VLM families)")
FAMILIES = ("dense", "moe")
WINDOW_ITEM = ("ROADMAP.md queue A item 5 (sliding-window rings and recurrent "
               "state, with the SSM and hybrid families)")
DOTS_REMAT_ITEM = "ROADMAP.md queue A item 10 (leftovers: selective \"dots\" remat)"
# _ce_sum chunks the batch when b % 32 == 0 and S * vocab reaches this
CE_CHUNK_MIN_ELEMS = 2**26


def _norm(cfg: ArchConfig, ctx: ModelContext, dim: int, name: str):
    cls = RMSNorm if cfg.norm == "rmsnorm" else LayerNorm
    return cls(dim, ctx, name=name)


@dataclasses.dataclass
class Block:
    """One pre-norm residual block: full attention + (MLP | MoE)."""

    cfg: ArchConfig
    ctx: ModelContext
    name: str = "block"
    use_moe: bool = False

    def __post_init__(self):
        cfg, ctx, d = self.cfg, self.ctx, self.cfg.d_model
        if cfg.window:
            raise NotImplementedError(
                f"sliding-window attention is not ported yet: {WINDOW_ITEM}")
        if cfg.kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"unknown kv_dtype {cfg.kv_dtype!r}")
        self.norm1 = _norm(cfg, ctx, d, f"{self.name}.norm1")
        self.mixer = Attention(
            d, cfg.n_heads, cfg.n_kv, ctx, head_dim=cfg.head_dim,
            name=f"{self.name}.attn", qkv_bias=cfg.qkv_bias,
            qk_norm=cfg.qk_norm, rope=cfg.rope_theta > 0,
            rope_theta=cfg.rope_theta or 10_000.0, q_chunk=cfg.attn_chunk,
        )
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
        return {"norm1": self.norm1.specs(), "mixer": self.mixer.specs(),
                "norm2": self.norm2.specs(), "ffn": self.ffn.specs()}

    def init_cache(self, n_pages: int, page_tokens: int, dtype, device) -> dict:
        """Paged K/V pool: (n_pages + 1, page_tokens, K, hd), the extra page
        being the scratch target of dropped writes (nn/attention.py). Under
        ``kv_dtype == "int8"`` the codes are int8 and their per-token, per-head
        scales ``ks`` / ``vs`` are (n_pages + 1, page_tokens, K) f32."""
        lead = (n_pages + 1, page_tokens, self.cfg.n_kv)
        shape = (*lead, self.mixer.hd)
        if self.cfg.kv_dtype == "int8":
            return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                    "v": torch.zeros(shape, dtype=torch.int8, device=device),
                    "ks": torch.zeros(lead, dtype=torch.float32, device=device),
                    "vs": torch.zeros(lead, dtype=torch.float32, device=device)}
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def _ffn(self, params, x):
        """x + FFN(norm2(x)) and the FFN's aux loss (an MoE's load-balance
        term; None for an MLP)."""
        h = self.norm2(params["norm2"], x)
        if self.use_moe:
            h, aux = self.ffn(params["ffn"], h)
            return x + h, aux
        return x + self.ffn(params["ffn"], h), None

    def __call__(self, params, x, *, positions=None):
        """Training forward of one block: x (B, S, d) -> ((B, S, d), aux)."""
        h = self.mixer(params["mixer"], self.norm1(params["norm1"], x),
                       positions=positions)
        return self._ffn(params, x + h)

    def decode_step(self, params, x, cache, *, lengths, page_table, active=None):
        h = self.norm1(params["norm1"], x)
        if "ks" in cache:
            h, cache = self.mixer.decode_step_quant(
                params["mixer"], h, cache, lengths, page_table, active=active)
        else:
            h, ck, cv = self.mixer.decode_step(
                params["mixer"], h, cache["k"], cache["v"], lengths,
                page_table, active=active)
            cache = {"k": ck, "v": cv}
        return self._ffn(params, x + h)[0], cache

    def extend(self, params, x, cache, *, positions, valid, page_table):
        h = self.norm1(params["norm1"], x)
        if "ks" in cache:
            h, cache = self.mixer.extend_quant(
                params["mixer"], h, cache, positions, valid, page_table)
        else:
            h, ck, cv = self.mixer.extend(
                params["mixer"], h, cache["k"], cache["v"], positions, valid,
                page_table)
            cache = {"k": ck, "v": cv}
        return self._ffn(params, x + h)[0], cache


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
    def init_caches(self, n_pages: int, page_tokens: int, dtype) -> list:
        """One paged pool per segment: each leaf of ``Block.init_cache``,
        with a leading layer axis for a stacked segment, e.g. {"k", "v"}
        (n_layers, n_pages + 1, page_tokens, K, hd)."""
        caches = []
        for seg in self.segments:
            c = seg.block.init_cache(n_pages, page_tokens, dtype, self.device)
            if seg.scanned:
                c = {k: v[None].repeat(seg.n, *([1] * v.ndim))
                     for k, v in c.items()}
            caches.append(c)
        return caches

    def _walk_segments(self, params, x, caches, step_fn):
        """Apply ``step_fn(block, layer_params, x, layer_cache)`` layer by
        layer. Layer params and caches are views into the stacked leaves,
        so the in-place pool writes land in the stacked cache."""
        for i, seg in enumerate(self.segments):
            for pl, cl in zip(seg.layers(params[f"seg{i}"]),
                              seg.layers(caches[i])):
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
