"""Encoder-decoder backbone, the seamless-m4t family (port of
``repro/models/encdec.py``).

The encoder consumes precomputed frame embeddings (the speech frontend is
a stub); the decoder is causal, with cross attention to the encoder
memory. Both stacks hold layer-stacked params (``enc``, ``dec``) that a
Python loop walks, as ``models/lm.py`` walks its segments in place of the
reference's ``lax.scan``.

Training: ``encode`` / ``decode`` / ``train_forward`` (chunked CE; each
layer checkpointed unless ``cfg.remat == "none"``).

Serving: the dense ``prefill`` + ``decode_step`` (``page_table`` None) is
the parity anchor, stacked per-slot rows of self and cross K/V. The
engine's path is paged: ``init_caches`` stands up two pools, ``self``
(the decoder's self-attention K/V, written by ``extend`` and
``decode_step``) and ``cross`` (the cross-attention K/V, written once a
request by ``write_cross`` in the ENCODE phase and only read after),
each ``(dec_layers, pages + 1, page_tokens, K, hd)`` with the last page
the scratch target of dropped writes (``nn/attention.py``). Each paged
entry point writes the pools in place, layer by layer, through views of
the stacked leaves, so the engine's captured graphs read and write the
tensors it holds. ``encode_serve`` is the fixed-shape encoder pass of the
ENCODE phase: padded frames are masked out as keys, so the rows of the
real frames equal an unpadded ``encode``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import remat
from repro_torch.models.lm import ce_sum, nll_sum
from repro_torch.nn import module as mod
from repro_torch.nn.attention import Attention, _attend_core, scatter_pages
from repro_torch.nn.context import ModelContext
from repro_torch.nn.embeddings import Embedding
from repro_torch.nn.ffn import MLP
from repro_torch.nn.linear import Dense
from repro_torch.nn.norms import LayerNorm, RMSNorm
from repro_torch.serve.servable import CacheFamily


def _norm(cfg: ArchConfig, ctx: ModelContext, name: str):
    cls = RMSNorm if cfg.norm == "rmsnorm" else LayerNorm
    return cls(cfg.d_model, ctx, name=name)


def _layers(tree, n: int):
    """The per-layer views of a layer-stacked param or cache tree."""
    return [mod.map_tree(lambda v, j=j: v[j], tree) for j in range(n)]


@dataclasses.dataclass
class EncBlock:
    cfg: ArchConfig
    ctx: ModelContext
    name: str = "enc"

    def __post_init__(self):
        cfg, c, d = self.cfg, self.ctx, self.cfg.d_model
        self.norm1 = _norm(cfg, c, f"{self.name}.norm1")
        self.attn = Attention(d, cfg.n_heads, cfg.n_kv, c, head_dim=cfg.head_dim,
                              name=f"{self.name}.attn", causal=False,
                              rope=cfg.rope_theta > 0, q_chunk=cfg.attn_chunk)
        self.norm2 = _norm(cfg, c, f"{self.name}.norm2")
        self.ffn = MLP(d, cfg.d_ff, c, name=f"{self.name}.mlp",
                       gated=cfg.gated_mlp, activation=cfg.activation)

    def specs(self) -> mod.SpecTree:
        return {"norm1": self.norm1.specs(), "attn": self.attn.specs(),
                "norm2": self.norm2.specs(), "ffn": self.ffn.specs()}

    def __call__(self, params, x, valid=None):
        """``valid`` (B, S) masks padded frames as keys: their softmax
        weight is exactly 0, so the valid rows equal an unpadded encode;
        the padded rows are position-wise garbage nothing reads."""
        x = x + self.attn(params["attn"], self.norm1(params["norm1"], x),
                          kv_valid=valid)
        return x + self.ffn(params["ffn"], self.norm2(params["norm2"], x))


@dataclasses.dataclass
class DecBlock:
    cfg: ArchConfig
    ctx: ModelContext
    name: str = "dec"

    def __post_init__(self):
        cfg, c, d = self.cfg, self.ctx, self.cfg.d_model
        self.norm1 = _norm(cfg, c, f"{self.name}.norm1")
        self.self_attn = Attention(d, cfg.n_heads, cfg.n_kv, c,
                                   head_dim=cfg.head_dim,
                                   name=f"{self.name}.self_attn",
                                   rope=cfg.rope_theta > 0, q_chunk=cfg.attn_chunk)
        self.norm2 = _norm(cfg, c, f"{self.name}.norm2")
        self.cross_attn = Attention(d, cfg.n_heads, cfg.n_kv, c,
                                    head_dim=cfg.head_dim,
                                    name=f"{self.name}.cross_attn", causal=False,
                                    cross=True, rope=False,
                                    q_chunk=cfg.attn_chunk)
        self.norm3 = _norm(cfg, c, f"{self.name}.norm3")
        self.ffn = MLP(d, cfg.d_ff, c, name=f"{self.name}.mlp",
                       gated=cfg.gated_mlp, activation=cfg.activation)

    def specs(self) -> mod.SpecTree:
        return {"norm1": self.norm1.specs(), "self_attn": self.self_attn.specs(),
                "norm2": self.norm2.specs(), "cross_attn": self.cross_attn.specs(),
                "norm3": self.norm3.specs(), "ffn": self.ffn.specs()}

    def __call__(self, params, x, memory):
        x = x + self.self_attn(params["self_attn"], self.norm1(params["norm1"], x))
        x = x + self.cross_attn(params["cross_attn"],
                                self.norm2(params["norm2"], x), kv_src=memory)
        return x + self.ffn(params["ffn"], self.norm3(params["norm3"], x))

    def decode_step(self, params, x, cache, lengths):
        """One token against dense per-slot rows: self K/V (B, T, K, hd)
        written at ``lengths`` into new tensors, cross K/V (B, T_enc, K,
        hd) from the prefill, every row attended."""
        h = self.norm1(params["norm1"], x)
        h, ck, cv = self.self_attn.decode_step(
            params["self_attn"], h, cache["k"], cache["v"], lengths, None)
        x = x + h
        mixer, b = self.cross_attn, x.shape[0]
        h = self.norm2(params["norm2"], x)
        q = mixer.wq(params["cross_attn"]["wq"], h).reshape(
            b, 1, mixer.n_heads, mixer.hd)
        mask = torch.ones((b, 1, cache["ck"].shape[1]), dtype=torch.bool,
                          device=x.device)
        out = _attend_core(mixer._group(q), cache["ck"], cache["cv"], mask,
                           1.0 / math.sqrt(mixer.hd))
        x = x + mixer.wo(params["cross_attn"]["wo"],
                         out.reshape(b, 1, mixer.n_heads * mixer.hd))
        x = x + self.ffn(params["ffn"], self.norm3(params["norm3"], x))
        return x, {**cache, "k": ck, "v": cv}


class EncDecModel:
    """seamless-m4t backbone: frame embeddings -> encoder -> text decoder."""

    # ServableModel probes: decoder self-attention pages its K/V; the
    # engine stands up the ENCODE phase and the cross-attention pool
    has_full_attn = True
    has_recurrent_state = False
    has_cross_attn = True

    def __init__(self, cfg: ArchConfig, ctx: Optional[ModelContext] = None):
        self.cfg = cfg
        self.ctx = ctx or ModelContext(policy=cfg.tbn)
        c, d = self.ctx, cfg.d_model
        self.frame_proj = Dense(d, d, c, name="frame_proj",
                                logical=("embed", "embed"))
        self.embed = Embedding(cfg.vocab, d, c, name="dec_embed")
        self.enc_block = EncBlock(cfg, c)
        self.dec_block = DecBlock(cfg, c)
        self.enc_norm = _norm(cfg, c, "enc_norm")
        self.dec_norm = _norm(cfg, c, "dec_norm")
        self.head = Dense(d, cfg.vocab, c, name="lm_head", kind="head",
                          logical=("vocab", "embed"))

    @property
    def device(self) -> torch.device:
        return self.ctx.device

    def specs(self) -> mod.SpecTree:
        return {
            "frame_proj": self.frame_proj.specs(),
            "embed": self.embed.specs(),
            "enc": mod.stack_specs(self.enc_block.specs(), self.cfg.enc_layers),
            "dec": mod.stack_specs(self.dec_block.specs(), self.cfg.dec_layers),
            "enc_norm": self.enc_norm.specs(),
            "dec_norm": self.dec_norm.specs(),
            "head": self.head.specs(),
        }

    def init(self, seed: int) -> dict:
        return mod.init_params(self.specs(), seed, self.device)

    def abstract(self) -> dict:
        return mod.abstract_params(self.specs())

    def logical(self) -> dict:
        return mod.logical_axes(self.specs())

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def _stack(self, params, name: str, n: int):
        """Layer views of a stacked tree, unbound so the layers' gradients
        stack back into the leaf."""
        return _layers(mod.map_tree(lambda v: v.unbind(0), params[name]), n)

    def _remat(self, fn, x, *args):
        """Every layer is checkpointed unless ``cfg.remat == "none"`` (the
        reference checkpoints under "full" and "dots" alike here)."""
        if self.cfg.remat == "none":
            return fn(x, *args)
        return remat(fn, x, *args)

    def encode(self, params, frames) -> torch.Tensor:
        """frames (B, S_enc, d_model) precomputed frontend embeddings ->
        the encoder memory (B, S_enc, d_model)."""
        x = self.frame_proj(params["frame_proj"], frames.to(self.device))
        for pl in self._stack(params, "enc", self.cfg.enc_layers):
            x = self._remat(lambda h, pl=pl: self.enc_block(pl, h), x)
        return self.enc_norm(params["enc_norm"], x)

    def decode(self, params, tokens, memory) -> torch.Tensor:
        x = self.embed(params["embed"], tokens)
        for pl in self._stack(params, "dec", self.cfg.dec_layers):
            x = self._remat(lambda h, m, pl=pl: self.dec_block(pl, h, m), x, memory)
        return self.dec_norm(params["dec_norm"], x)

    def train_forward(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        """Next-token CE of the decoder over ``batch["tokens"]`` (B, S)
        given ``batch["frames"]`` (B, S_enc, d); full-sequence logits with
        the shifted last position masked out, batch-chunked when large."""
        memory = self.encode(params, batch["frames"])
        tokens = batch["tokens"].to(self.device).long()
        b, s = tokens.shape
        h = self.decode(params, tokens, memory)
        targets = torch.roll(tokens, -1, dims=1)
        valid = (torch.arange(s, device=self.device) < s - 1).float()[None, :]
        mask = valid.expand(b, s)
        nll = ce_sum(lambda hc, tc, mc: nll_sum(self.head(params["head"], hc),
                                                tc, mc),
                     h, targets, mask, self.cfg.vocab)
        ce = nll / mask.sum().clamp_min(1.0)
        return ce, {"ce": ce, "aux": torch.zeros((), device=self.device)}

    # ------------------------------------------------------------------
    # serving: the dense parity anchor
    # ------------------------------------------------------------------
    def prefill(self, params, batch, max_len: int):
        """Encode the frames and run the decoder prompt -> (last-position
        logits (B, vocab), dense caches {"k", "v": (L, B, max_len, K, hd),
        "ck", "cv": (L, B, S_enc, K, hd)}, lengths)."""
        memory = self.encode(params, batch["frames"])
        tokens = batch["tokens"].to(self.device).long()
        b, s = tokens.shape
        x = self.embed(params["embed"], tokens)
        blk, per_layer = self.dec_block, []
        for pl in _layers(params["dec"], self.cfg.dec_layers):
            hh = blk.norm1(pl["norm1"], x)
            _, (k, v) = blk.self_attn.prefill(pl["self_attn"], hh)
            x = blk(pl, x, memory)
            t, mixer = memory.shape[1], blk.cross_attn
            ck = mixer.wk(pl["cross_attn"]["wk"], memory).reshape(
                b, t, mixer.n_kv, mixer.hd)
            cv = mixer.wv(pl["cross_attn"]["wv"], memory).reshape(
                b, t, mixer.n_kv, mixer.hd)
            pad = (0, 0, 0, 0, 0, max_len - s)
            per_layer.append({"k": torch.nn.functional.pad(k, pad),
                              "v": torch.nn.functional.pad(v, pad),
                              "ck": ck, "cv": cv})
        caches = {n: torch.stack([c[n] for c in per_layer]) for n in per_layer[0]}
        h = self.dec_norm(params["dec_norm"], x[:, -1:])
        lengths = torch.full((b,), s, dtype=torch.int32, device=self.device)
        return self.head(params["head"], h)[:, 0], caches, lengths

    def decode_step(self, params, tokens, caches, lengths, page_table=None,
                    active=None, cross_page_table=None, enc_lens=None):
        """One-token decode. ``page_table`` None: the dense anchor over
        :meth:`prefill`'s stacked rows (new tensors returned). With
        ``page_table`` both families are pools: self-attention K/V scatter
        through ``page_table`` (inactive slots drop their write, in place)
        and the read-only cross K/V are read through ``cross_page_table``,
        masked by ``enc_lens``."""
        if page_table is None:
            return self._decode_step_dense(params, tokens, caches, lengths)
        x = self.embed(params["embed"], tokens)
        x = self._walk_dec_paged(
            params, x, caches,
            lambda blk, pl, a, kl, vl: blk.self_attn.decode_step(
                pl["self_attn"], a, kl, vl, lengths, page_table, active=active),
            cross_page_table, enc_lens)
        h = self.dec_norm(params["dec_norm"], x)
        return self.head(params["head"], h)[:, 0], caches, lengths + 1

    def _decode_step_dense(self, params, tokens, caches, lengths):
        x = self.embed(params["embed"], tokens)
        per_layer = []
        for pl, cl in zip(_layers(params["dec"], self.cfg.dec_layers),
                          _layers(caches, self.cfg.dec_layers)):
            x, c2 = self.dec_block.decode_step(pl, x, cl, lengths)
            per_layer.append(c2)
        caches = {n: torch.stack([c[n] for c in per_layer]) for n in per_layer[0]}
        h = self.dec_norm(params["dec_norm"], x)
        return self.head(params["head"], h)[:, 0], caches, lengths + 1

    # ------------------------------------------------------------------
    # serving: the paged path (ServableModel)
    # ------------------------------------------------------------------
    def cache_families(self):
        return (CacheFamily("self_attn", paged=True),
                CacheFamily("cross_attn", paged=True, read_only=True))

    def init_caches(self, batch: int, max_len: int, dtype,
                    page_tokens: Optional[int] = None,
                    n_pages: Optional[int] = None,
                    cross_pages: Optional[int] = None) -> dict:
        """Pool-form caches: both families are pages addressed through
        separate tables, {"self": {"k", "v"}, "cross": {"k", "v"}}, each
        (dec_layers, pages + 1, page_tokens, K, hd); no dense (n_slots, T)
        row anywhere."""
        if page_tokens is None:
            raise ValueError(
                "EncDecModel serves paged-only: pass page_tokens/n_pages/"
                "cross_pages (the dense reference path builds its caches "
                "via prefill, not init_caches)")
        n, kv, hd = self.cfg.dec_layers, self.cfg.n_kv, self.dec_block.self_attn.hd

        def pool(pages):
            return torch.zeros((n, pages + 1, page_tokens, kv, hd), dtype=dtype,
                               device=self.device)

        return {"self": {"k": pool(n_pages), "v": pool(n_pages)},
                "cross": {"k": pool(cross_pages), "v": pool(cross_pages)}}

    def encode_serve(self, params, frames, valid) -> torch.Tensor:
        """The ENCODE phase's fixed-shape encoder pass: ``frames`` (1,
        enc_tokens, d) zero-padded, ``valid`` (1, enc_tokens) marking the
        real frames; rows below the frame count equal :meth:`encode` of
        the unpadded frames."""
        x = self.frame_proj(params["frame_proj"], frames)
        for pl in _layers(params["enc"], self.cfg.enc_layers):
            x = self.enc_block(pl, x, valid=valid)
        return self.enc_norm(params["enc_norm"], x)

    def write_cross(self, params, memory, caches, xptab, positions, valid):
        """Project ``memory`` (1, enc_tokens, d) to each decoder layer's
        cross K/V and scatter them into the cross pool, in place, through
        the slot's cross page-table row ``xptab`` (1, x_npp); padded frames
        (``valid`` False) land on the scratch page. Runs once a request;
        nothing writes these pages again until they are released."""
        for j, pl in enumerate(_layers(params["dec"], self.cfg.dec_layers)):
            k, v = self.dec_block.cross_attn.cross_kv(pl["cross_attn"], memory)
            scatter_pages(caches["cross"]["k"][j], xptab, positions, k, valid)
            scatter_pages(caches["cross"]["v"][j], xptab, positions, v, valid)
        return caches

    def _walk_dec_paged(self, params, x, caches, self_step, xptab, enc_lens):
        """The decoder layers over the pools: self attention through
        ``self_step(block, layer params, h, k pool, v pool)`` (decode or
        extend; it writes the layer's self pool in place), the read-only
        cross attend, the FFN, in DecBlock's residual order."""
        blk = self.dec_block
        for j, pl in enumerate(_layers(params["dec"], self.cfg.dec_layers)):
            a, _, _ = self_step(blk, pl, blk.norm1(pl["norm1"], x),
                                caches["self"]["k"][j], caches["self"]["v"][j])
            x = x + a
            x = x + blk.cross_attn.cross_attend(
                pl["cross_attn"], blk.norm2(pl["norm2"], x),
                caches["cross"]["k"][j], caches["cross"]["v"][j], enc_lens,
                page_table=xptab)
            x = x + blk.ffn(pl["ffn"], blk.norm3(pl["norm3"], x))
        return x

    def extend(self, params, tokens, caches, lengths, n_new, page_table=None,
               cross_page_table=None, enc_lens=None):
        """Chunked-prefill step over the pools (DecoderLM.extend's column
        semantics: padding columns never write, a slot's logits come from
        its last valid column)."""
        if page_table is None:
            raise ValueError("EncDecModel.extend is paged-only")
        b, c = tokens.shape
        cols = torch.arange(c, device=tokens.device)[None, :]
        positions = lengths[:, None] + cols
        valid = cols < n_new[:, None]
        x = self.embed(params["embed"], tokens)
        x = self._walk_dec_paged(
            params, x, caches,
            lambda blk, pl, a, kl, vl: blk.self_attn.extend(
                pl["self_attn"], a, kl, vl, positions, valid, page_table),
            cross_page_table, enc_lens)
        idx = (n_new.long() - 1).clamp(0, c - 1)
        h_last = torch.gather(x, 1, idx[:, None, None].expand(b, 1, x.shape[-1]))
        h = self.dec_norm(params["dec_norm"], h_last)
        return self.head(params["head"], h)[:, 0], caches, lengths + n_new

    # ---- per-slot walkers: everything is paged, so they pass through ----
    def merge_caches(self, old, new, keep, paged: bool = False):
        return new      # pool writes were confined by ``active``

    def reset_slot_caches(self, caches, slot, paged: bool = False):
        return caches   # stale pool rows are position-masked

    def snapshot_slot_caches(self, caches, slot):
        return None     # no per-slot family to pin

    def restore_slot_caches(self, caches, slot, snaps):
        return caches
