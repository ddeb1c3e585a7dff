"""Multi-head attention: GQA, RoPE, sliding windows, the training call
(causal or not, full or query-chunked, self or cross attention over an
encoder memory with a key mask), the monolithic prefill, and the serving
caches: the paged KV pool, in the compute dtype or as int8 codes with
per-token, per-head f32 scales, the dense per-slot cache a monolithic
prefill hands to ``decode_step``, and the read-only cross-attention pool of
the encoder-decoder family (``cross_kv`` writes its rows once a request,
``cross_attend`` reads them) (port of ``repro/nn/attention.py``). The
windowed ring cache of serving lives in ``models/lm.py``, as in the
reference.

Under a mesh the serving entry points of a layer whose ``act_mode`` is
"heads" (the config's ``attn_act``, the reference's recipe of q, k and v
constrained to their heads over "model") run on the rank's block of the
heads (``distributed.sharding.head_sharding``): the q / k / v projections
keep only the block's output columns, the rank's caches hold only its
block of the K/V heads, and the attention output is gathered by heads
over the block's axes before ``wo``, which runs whole. Every head's
arithmetic is one card's, so the gathered output equals it. Where the
rule does not divide the heads, on one device and in the training call,
every head runs on every rank.

A layer whose ``act_mode`` is "seq" (the reference's q, k and v
sequence-sharded over "model") splits the time rows of its serving caches
instead (``distributed.sharding.seq_sharding``, where the rule's axes
divide the cache's length): absolute position p lives on the rank of
index p mod TP, at local row (p mod page_tokens) // TP of its page, row
p // TP of a dense slot cache, and ring row (p mod t) // TP of a window
ring of t rows (``models/lm.py``). The rank that owns a new row writes
it; the others drop the write to scratch. Every rank projects every head
of every query, attends its queries against its own rows
(``_partial_core``: the row maximum, the sum of exponentials and the
unnormalised output, in f64: kernel B9, ``kernels/seq_attend.py``, on
the card; its plain version on the host) and merges every rank's parts
after one gather a layer (``sharding.merge_partials``), rounding once. On
one card a "seq" serving layer attends through B9 too, as the merge's one
part (the kernel divides and rounds once), so one card and every mesh
give the same values. On one host device it attends as every other layer
does (``_attend_core``, in the reference's CPU orders). The monolithic
prefill and the training call attend whole; the prefill's
caches keep the rank's rows (``models/lm.py``). The caller that lays out
or reads a cache knows its whole length (the engine's page_tokens and
max_len, a window ring's length) and passes the entry points its
``SeqBlock`` (``Attention.seq_block``); a cache the rule does not divide
stays whole, and so does its attention.

Where a model's serving entry point runs the rank's block of the slots
(``sharding.slot_rows``, the data axes' split of the batch), x holds the
rank's rows while the per-slot vectors the entry points take (lengths,
positions, valid, active, page tables) stay whole: a layer reads its
rows of them, writes the pool (whole on every rank) at every slot's
positions after one gather of the new K/V rows over the data axes, and
attends its own slots' pages.

The softmax core is written in plain torch ops, as the reference writes it
in jnp, so the parity tests compare like with like. A masked key gets
``NEG_INF`` = -1e30, not -inf: its softmax weight underflows to exactly 0,
and a row whose keys are all masked (a padded encoder frame, a free slot's
cross attend) stays finite instead of turning NaN.

Paged pool layout: a cache leaf is ``(n_pages + 1, page_tokens, K, hd)``
(an int8 cache adds the scale pools ``ks`` / ``vs``, ``(n_pages + 1,
page_tokens, K)`` f32, addressed through the same page table).
Pages 0..n_pages-1 are addressed through the engine's page table exactly
as in the reference; the extra last page is scratch. The reference drops
invalid writes with ``.at[idx].set(mode="drop")`` on an out-of-range
index; torch's ``index_put_`` raises on one instead, so here every invalid
write lands on the first row of the scratch page, which no page table ever
maps and nothing reads back. Writes update the pool in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.ordered import XLA_EXACT_MAX_MACS, ordered_dot, xla_softmax
from repro_torch.distributed.sharding import (
    HeadBlock,
    SeqBlock,
    active_mesh,
    active_slots,
    gather_blocks,
    head_sharding,
    merge_partials,
    seq_sharding,
    slots_local,
)
from repro_torch.kernels.seq_attend import NEG_INF, seq_attend
from repro_torch.nn import module as mod
from repro_torch.nn.context import ModelContext
from repro_torch.nn.linear import Dense
from repro_torch.nn.norms import RMSNorm
from repro_torch.nn.rotary import apply_rope


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., hd) -> (int8 codes (..., hd), f32 scale (...)): symmetric,
    per token and head, scale = max(amax, 1e-8) / 127. Requantizing an
    unchanged row gives back its codes (max |code| is exactly 127), so
    rows written again never drift. The f32 division (not a reciprocal
    multiply) and ``torch.round``'s half to even give the reference's
    codes."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1).clamp_min(1e-8)
    # divided by a tensor: CUDA turns division by a Python scalar into a
    # multiply by its reciprocal, whose rounding differs
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    return q.to(dtype) * scale[..., None].to(dtype)


def gather_pages(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Per-slot contiguous cache view through the page table: pool
    (n_pages + 1, pt, ...) + page_table (B, npp) -> (B, npp * pt, ...),
    row p of slot b's view being the entry for absolute position p."""
    pt = pool.shape[1]
    flat = pool.reshape(-1, *pool.shape[2:])
    idx = (page_table.long()[:, :, None] * pt
           + torch.arange(pt, device=pool.device)[None, None, :])
    return flat[idx.reshape(page_table.shape[0], -1)]


def scatter_pages(pool: torch.Tensor, page_table: torch.Tensor,
                  positions: torch.Tensor, values: torch.Tensor,
                  valid: torch.Tensor, seq: Optional[SeqBlock] = None
                  ) -> torch.Tensor:
    """Write cache rows at absolute ``positions`` (B, C) through the page
    table, in place. Invalid columns — padding, inactive slots, negative
    positions and positions past the table's reach — go to the scratch
    row and are never read. Under ``seq`` the pool holds the rank's rows of
    each page (``page_tokens / extent`` of them): a position lands at local
    row (p mod page_tokens) // extent on the rank of index p mod extent,
    and the other ranks drop it to scratch."""
    n_rows, rows = (pool.shape[0] - 1) * pool.shape[1], pool.shape[1]
    npp = page_table.shape[1]
    flat = pool.view(-1, *pool.shape[2:])
    positions = positions.long()
    pt = rows if seq is None else rows * seq.extent
    pidx = torch.div(positions, pt, rounding_mode="floor")
    page = torch.gather(page_table.long(), 1, pidx.clamp(0, npp - 1))
    ok = valid & (pidx < npp) & (positions >= 0)
    row = positions % pt
    if seq is not None:
        ok = ok & (positions % seq.extent == seq.index)
        row = torch.div(row, seq.extent, rounding_mode="floor")
    idx = torch.where(ok, page * rows + row, n_rows)
    flat[idx.reshape(-1)] = values.reshape(-1, *pool.shape[2:]).to(pool.dtype)
    return pool


def _attend_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: torch.Tensor, scale: float) -> torch.Tensor:
    """q (B, S, K, G, hd) grouped queries; k, v (B, T, K, hd); mask (B, S, T)
    or (S, T), True = attend -> (B, S, K, G, hd). f32 on the host, up to
    ``XLA_EXACT_MAX_MACS``, in the reference's arithmetic: its dot orders
    and its exp (``core.ordered``), so the integer paths' quantizers meet
    the reference's bits."""
    mask_b = mask[None, None, None] if mask.ndim == 2 else mask[:, None, None]
    if (q.device.type == "cpu" and q.dtype == k.dtype == v.dtype == torch.float32
            and q.numel() * k.shape[1] <= XLA_EXACT_MAX_MACS):
        rows = q.shape[1] * q.shape[3]
        scores = ordered_dot(q.permute(0, 2, 3, 1, 4)[:, :, :, :, None],
                             k.permute(0, 2, 1, 3)[:, :, None, None], rows) * scale
        probs = xla_softmax(torch.where(mask_b, scores, NEG_INF))
        return ordered_dot(probs.permute(0, 3, 1, 2, 4)[..., None, :],
                           v.permute(0, 2, 3, 1)[:, None, :, None], rows)
    scores = torch.einsum("bskgh,btkh->bkgst", q, k).float() * scale
    scores = torch.where(mask_b, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgst,btkh->bskgh", probs, v)


def _partial_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor, scale: float, ks=None, vs=None):
    """``_attend_core``'s arguments over a rank's keys (int8 codes with
    their scales ``ks`` / ``vs``, in ``_attend_quant``'s order) -> its
    partial softmax (o (B, S, K, G, hd), m, l (B, S, K, G)) in f64: o = sum
    e v, unnormalised, e = exp(s - m) at valid keys and exactly 0 at the
    others; ``sharding.merge_partials`` combines every rank's. Kernel B9
    (``kernels/seq_attend.py``) on the card, its plain version on the
    host. In f64 the result rounds to the same f32 or bf16 value however
    the keys are split over ranks (but for a value within ~1e-15 of a
    rounding boundary)."""
    return seq_attend(q, k, v, ks, vs, mask, scale)


def _pool_rows(k: torch.Tensor, v: torch.Tensor):
    """A tick's new K/V rows (B, C, K, hd) of the rank's slots -> every
    slot's, for a pool every rank holds whole: one gather of k and v
    together over the active slot block's axes (``sharding.slot_rows``);
    as given where the rows are whole."""
    block = active_slots()
    if block is None:
        return k, v
    kv = block.gather(torch.cat([k, v], dim=-1), 0)
    return kv[..., :k.shape[-1]], kv[..., k.shape[-1]:]


def make_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool = True,
              window: Optional[int] = None,
              k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(S, T) or (B, S, T) attend-mask from position vectors."""
    m = torch.ones((*q_pos.shape, k_pos.shape[-1]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= q_pos[..., :, None] >= k_pos[..., None, :]
    if window is not None:
        m &= q_pos[..., :, None] - k_pos[..., None, :] < window
    if k_valid is not None:
        m &= k_valid[..., None, :]
    return m


@dataclasses.dataclass
class Attention:
    d_model: int
    n_heads: int
    n_kv: int
    ctx: ModelContext
    head_dim: Optional[int] = None
    name: str = "attn"
    qkv_bias: bool = False
    qk_norm: bool = False
    rope: bool = True
    rope_theta: float = 10_000.0
    q_chunk: int = 1024                 # chunked training path query block
    window: Optional[int] = None        # sliding-window size (recurrentgemma)
    causal: bool = True
    cross: bool = False                 # encoder-decoder cross attention
    act_mode: str = "heads"             # "heads" | "seq" (see configs.base)

    def __post_init__(self):
        self.hd = self.head_dim or self.d_model // self.n_heads
        assert self.n_heads % self.n_kv == 0
        self.groups = self.n_heads // self.n_kv
        c, d, hd = self.ctx, self.d_model, self.hd
        self.wq = Dense(d, self.n_heads * hd, c, name=f"{self.name}.wq",
                        logical=("heads", "embed"), use_bias=self.qkv_bias)
        self.wk = Dense(d, self.n_kv * hd, c, name=f"{self.name}.wk",
                        logical=("heads", "embed"), use_bias=self.qkv_bias)
        self.wv = Dense(d, self.n_kv * hd, c, name=f"{self.name}.wv",
                        logical=("heads", "embed"), use_bias=self.qkv_bias)
        self.wo = Dense(self.n_heads * hd, d, c, name=f"{self.name}.wo",
                        logical=("embed", "heads"))
        if self.qk_norm:
            self.qnorm = RMSNorm(hd, c, name=f"{self.name}.qnorm")
            self.knorm = RMSNorm(hd, c, name=f"{self.name}.knorm")

    def specs(self) -> mod.SpecTree:
        out = {"wq": self.wq.specs(), "wk": self.wk.specs(),
               "wv": self.wv.specs(), "wo": self.wo.specs()}
        if self.qk_norm:
            out["qnorm"] = self.qnorm.specs()
            out["knorm"] = self.knorm.specs()
        return out

    def heads(self) -> Optional[HeadBlock]:
        """The rank's block of this layer's heads under the active rules
        (the "heads" recipe, where the model axis divides n_kv and
        n_heads), or None: every head. A sliding-window layer keeps every
        head: its serving ring (``models/lm.py``) is whole."""
        if self.act_mode != "heads" or self.window:
            return None
        return head_sharding(self.n_heads, self.n_kv)

    def seq_block(self, length: Optional[int]) -> Optional[SeqBlock]:
        """The rank's share of the time rows of a serving cache of
        ``length`` rows (a page, a dense slot row, a window ring) under the
        active rules: the "seq" recipe, where the "act_res_seq" rule's axes
        divide ``length``; or None: every row (a "heads" layer, a cross
        layer, one device, a length the rule does not divide). The serving
        entry points take it as ``seq``; a "seq" layer under a mesh raises
        without the cache's length, since a rank's rows cannot tell it."""
        if self.act_mode != "seq" or self.cross or active_mesh() is None:
            return None
        if length is None:
            raise ValueError(f"{self.name}: a \"seq\" layer under a mesh needs its "
                             f"cache's whole length (page_tokens / max_len)")
        return seq_sharding(length)

    def kv_heads(self) -> int:
        """The K/V heads this rank's serving caches hold: its block's under
        the active rules, else every one."""
        hb = self.heads()
        return self.n_kv if hb is None else self.n_kv // hb.extent

    def _proj(self, name: str, params, x, n: int,
              hb: Optional[HeadBlock]) -> torch.Tensor:
        """x through ``name`` (wq / wk / wv, n heads) -> (B, S, heads, hd):
        every head, or the block ``hb`` of them (the block's columns of
        the whole output, each the same product as one card's)."""
        y = getattr(self, name)(params[name], x)
        if hb is not None:
            width = n // hb.extent * self.hd
            y = y[..., hb.index * width:(hb.index + 1) * width]
        return y.reshape(*x.shape[:2], -1, self.hd)

    def _out(self, params, out: torch.Tensor,
             hb: Optional[HeadBlock]) -> torch.Tensor:
        """``wo`` of the attention output (B, S, heads..., hd): a block of
        heads is first gathered by heads over the block's axes, so ``wo``
        takes every head in order."""
        out = out.reshape(*out.shape[:2], -1)
        if hb is not None:
            out = gather_blocks(out, hb.mesh, hb.axes, -1)
        return self.wo(params["wo"], out)

    def _qkv(self, params, x, positions, kv_src=None, kv_positions=None,
             heads: Optional[HeadBlock] = None):
        """q from x; k, v from ``kv_src`` (a cross layer's memory) or x:
        every head, or the block ``heads`` of them. RoPE at ``positions`` /
        ``kv_positions`` (default: ``positions``), never on a cross
        layer."""
        src = x if kv_src is None else kv_src
        q = self._proj("wq", params, x, self.n_heads, heads)
        k = self._proj("wk", params, src, self.n_kv, heads)
        v = self._proj("wv", params, src, self.n_kv, heads)
        if self.qk_norm:
            q = self.qnorm(params["qnorm"], q)
            k = self.knorm(params["knorm"], k)
        if self.rope and not self.cross:
            q = apply_rope(q, positions, self.rope_theta)
            k = apply_rope(k, positions if kv_positions is None else kv_positions,
                           self.rope_theta)
        return q, k, v

    def _group(self, q):
        """(B, S, heads, hd) -> (B, S, K/V heads, groups, hd)."""
        b, s = q.shape[:2]
        return q.reshape(b, s, -1, self.groups, self.hd)

    def __call__(self, params: dict, x: torch.Tensor, *,
                 positions: Optional[torch.Tensor] = None,
                 kv_src: Optional[torch.Tensor] = None,
                 kv_valid: Optional[torch.Tensor] = None,
                 chunked: Optional[bool] = None) -> torch.Tensor:
        """Attention over x (B, S, d), as in training: self-attention, or
        cross attention over the memory ``kv_src`` (B, T, d) (key positions
        0..T-1). ``kv_valid`` (B, T) masks keys (padded encoder frames).
        Causal unless ``causal`` is False or the layer is a cross layer.
        Queries are processed in chunks of ``q_chunk`` once S >= 4 *
        q_chunk."""
        b, s, _ = x.shape
        if positions is None:
            positions = torch.arange(s, device=x.device).expand(b, s)
        if kv_src is None:
            kv_positions = positions
        else:
            t = kv_src.shape[1]
            kv_positions = torch.arange(t, device=x.device).expand(b, t)
        q, k, v = self._qkv(params, x, positions, kv_src, kv_positions)
        scale = 1.0 / math.sqrt(self.hd)
        if chunked is None:
            chunked = s >= 4 * self.q_chunk
        if chunked:
            out = self._chunked(q, k, v, positions, kv_positions, scale, kv_valid)
        else:
            out = _attend_core(self._group(q), k, v,
                               make_mask(positions, kv_positions,
                                         causal=self.causal and not self.cross,
                                         window=self.window, k_valid=kv_valid),
                               scale)
        return self.wo(params["wo"], out.reshape(b, s, self.n_heads * self.hd))

    def _chunked(self, q, k, v, q_pos, k_pos, scale, k_valid=None):
        """A loop over query chunks; score memory is (chunk, T) per step.
        Each chunk is checkpointed, so the backward recomputes one chunk's
        scores at a time instead of keeping all of them."""
        s = q.shape[1]
        c = min(self.q_chunk, s)
        while s % c:
            c -= 1
        qg = self._group(q)
        causal = self.causal and not self.cross

        def step(qi, qpi):
            return _attend_core(qi, k, v, make_mask(
                qpi, k_pos, causal=causal, window=self.window,
                k_valid=k_valid), scale)

        return torch.cat([
            checkpoint(step, qg[:, i:i + c], q_pos[:, i:i + c],
                       use_reentrant=False)
            for i in range(0, s, c)], dim=1)

    def prefill(self, params: dict, x: torch.Tensor,
                positions: Optional[torch.Tensor] = None):
        """Forward over the whole prompt -> (y, (k, v)), k and v (B, S, K,
        hd) being the cache content (the rank's block of K under a head
        block; every row under the "seq" recipe, which attends whole here:
        the model keeps the rank's rows of the padded cache)."""
        b, s, _ = x.shape
        if positions is None:
            positions = torch.arange(s, device=x.device).expand(b, s)
        hb = self.heads()
        q, k, v = self._qkv(params, x, positions, heads=hb)
        scale = 1.0 / math.sqrt(self.hd)
        if s >= 4 * self.q_chunk:
            out = self._chunked(q, k, v, positions, positions, scale)
        else:
            out = _attend_core(self._group(q), k, v,
                               make_mask(positions, positions,
                                         window=self.window), scale)
        return self._out(params, out, hb), (k, v)

    def _decode_dense(self, params, q, cache, lengths, rows, hb, sb):
        """Dense per-slot cache: write each slot's new ``rows`` at
        ``lengths`` into a copy of every leaf of ``cache`` ((B, T, ...)),
        then attend over it (q and the cache: the head block ``hb``'s).
        Under a ``SeqBlock`` the rank holds rows p // TP of the positions p
        of its index mod TP: the owner writes, the other ranks keep the
        row. Returns (y, the new cache)."""
        b = q.shape[0]
        idx = torch.arange(b, device=q.device)
        new = {}
        for name, leaf in cache.items():
            leaf = leaf.clone()
            row = rows[name].to(leaf.dtype)
            if sb is None:
                leaf[idx, lengths.long()] = row
            else:
                at = torch.div(lengths, sb.extent, rounding_mode="floor").long()
                at = at.clamp_max(leaf.shape[1] - 1)
                own = (lengths % sb.extent == sb.index).view(b, *[1] * (row.ndim - 1))
                leaf[idx, at] = torch.where(own, row, leaf[idx, at])
            new[name] = leaf
        k_pos = self._key_positions(new["k"].shape[1], b, sb, q.device)
        mask = make_mask(lengths[:, None], k_pos, causal=True,
                         window=self.window, k_valid=k_pos <= lengths[:, None])
        if "ks" in new:
            views = [new[n] for n in ("k", "v", "ks", "vs")]
            return self._attend_quant(params, q, views, mask,
                                      self.ctx.compute_dtype, hb, sb), new
        return self._out(params, self._attend(q, new["k"], new["v"], mask, sb),
                         hb), new

    @staticmethod
    def _key_positions(t: int, b: int, sb: Optional[SeqBlock], device):
        """(B, t) absolute positions of a per-slot view of ``t`` cache rows:
        0..t-1, or the rank's positions under a ``SeqBlock``."""
        pos = (torch.arange(t, device=device) if sb is None
               else sb.positions(t, device))
        return pos.expand(b, t)

    def _one_part(self, q: torch.Tensor) -> bool:
        """A "seq" serving layer on a card attends as the mesh's one part
        (kernel B9, rounded once), where no ``SeqBlock`` splits its rows."""
        return self.act_mode == "seq" and not self.cross and q.device.type == "cuda"

    def _attend_seq(self, q, views, mask, sb: Optional[SeqBlock]) -> torch.Tensor:
        """B9 (its plain version on the host) over this rank's keys
        ``views`` (k, v, and the scales of int8 codes) -> (B, S, K, G, hd)
        in q's dtype: one part rounded once in the kernel without a
        ``SeqBlock`` (one card), else merged with every other rank's parts
        (one gather) and rounded once."""
        k, v, ks, vs = (*views, None, None)[:4]
        qg, scale = self._group(q).contiguous(), 1.0 / math.sqrt(self.hd)
        if sb is None:
            return seq_attend(qg, k, v, ks, vs, mask, scale, q.dtype)[0]
        o, m, l = _partial_core(qg, k, v, mask, scale, ks, vs)
        return merge_partials(o, m, l, sb).to(q.dtype)

    def _attend(self, q, k, v, mask, sb: Optional[SeqBlock]) -> torch.Tensor:
        """The attention of q (B, S, heads, hd) over k, v (B, T, K, hd) under
        ``mask`` -> (B, S, K, G, hd): ``_attend_core``, or B9 under a
        ``SeqBlock`` or on a card (``_attend_seq``)."""
        if sb is None and not self._one_part(q):
            return _attend_core(self._group(q), k, v, mask, 1.0 / math.sqrt(self.hd))
        return self._attend_seq(q, (k, v), mask, sb)

    def _attend_paged(self, params, q, cache_k, cache_v, page_table, positions,
                      hb, lengths=None, sb=None):
        """Attend q at ``positions`` over the pool's per-slot views (keys
        past ``lengths`` masked where given)."""
        view_k = gather_pages(cache_k, page_table)
        view_v = gather_pages(cache_v, page_table)
        k_pos = self._key_positions(view_k.shape[1], q.shape[0], sb, q.device)
        mask = make_mask(positions, k_pos, causal=True, window=self.window,
                         k_valid=None if lengths is None
                         else k_pos <= lengths[:, None])
        return self._out(params, self._attend(q, view_k, view_v, mask, sb), hb)

    def decode_step(self, params: dict, x: torch.Tensor, cache_k: torch.Tensor,
                    cache_v: torch.Tensor, lengths: torch.Tensor,
                    page_table: Optional[torch.Tensor],
                    active: Optional[torch.Tensor] = None,
                    seq: Optional[SeqBlock] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One-token step: x (B, 1, d) at position ``lengths``; the new K/V
        row scatters through the table (inactive slots drop their write)
        and the attend runs over the gathered per-slot view. With
        ``page_table`` None the caches are dense (B, T, K, hd) slot rows (a
        monolithic prefill's): every slot writes its row into new tensors,
        which are returned. Under ``seq`` (``seq_block``) the caches hold
        the rank's time rows; under a slot block the rank's slots (x, the
        dense caches), ``lengths`` / ``page_table`` / ``active`` whole."""
        lengths_l = slots_local(lengths)
        positions = lengths_l[:, None]
        hb = self.heads()
        q, k, v = self._qkv(params, x, positions, heads=hb)
        if page_table is None:
            y, new = self._decode_dense(params, q, {"k": cache_k, "v": cache_v},
                                        lengths_l, {"k": k[:, 0], "v": v[:, 0]},
                                        hb, seq)
            return y, new["k"], new["v"]
        ok = (torch.ones((page_table.shape[0],), dtype=torch.bool, device=x.device)
              if active is None else active)[:, None]
        k, v = _pool_rows(k, v)
        scatter_pages(cache_k, page_table, lengths[:, None], k, ok, seq)
        scatter_pages(cache_v, page_table, lengths[:, None], v, ok, seq)
        y = self._attend_paged(params, q, cache_k, cache_v, slots_local(page_table),
                               positions, hb, lengths_l, seq)
        return y, cache_k, cache_v

    def extend(self, params: dict, x: torch.Tensor, cache_k: torch.Tensor,
               cache_v: torch.Tensor, positions: torch.Tensor,
               valid: torch.Tensor, page_table: torch.Tensor,
               seq: Optional[SeqBlock] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Chunked-prefill step: column j of row b carries the token at
        ``positions[b, j]``; padding columns (valid False) never write.
        Queries attend causally over the just-updated cache (the rank's
        time rows under ``seq``; under a slot block its slots' rows, with
        ``positions`` / ``valid`` / ``page_table`` whole)."""
        hb = self.heads()
        positions_l = slots_local(positions)
        q, k, v = self._qkv(params, x, positions_l, heads=hb)
        k, v = _pool_rows(k, v)
        scatter_pages(cache_k, page_table, positions, k, valid, seq)
        scatter_pages(cache_v, page_table, positions, v, valid, seq)
        y = self._attend_paged(params, q, cache_k, cache_v, slots_local(page_table),
                               positions_l, hb, sb=seq)
        return y, cache_k, cache_v

    # ------------------------------------------------------------------
    # cross attention (encoder-decoder serving)
    # ------------------------------------------------------------------
    def cross_kv(self, params: dict, memory: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Encoder memory (B, T, d) -> cross-attention rows k, v (B, T, K,
        hd): computed once a request in the engine's ENCODE phase and
        written into the read-only cross pool. No RoPE (cross attention is
        position-free); ``knorm`` under ``qk_norm``, as in ``_qkv``. Under a
        head block, the rank's K/V heads."""
        hb = self.heads()
        k = self._proj("wk", params, memory, self.n_kv, hb)
        v = self._proj("wv", params, memory, self.n_kv, hb)
        if self.qk_norm:
            k = self.knorm(params["knorm"], k)
        return k, v

    def cross_attend(self, params: dict, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     kv_lens: torch.Tensor,
                     page_table: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Read-only cross attention: the queries of x (B, S, d) attend
        every valid memory row (row t of slot b iff ``t < kv_lens[b]``), no
        causal mask, no write. With ``page_table`` the caches are the cross
        pool, gathered per slot; rows past ``kv_lens`` (the last page's
        tail, stale rows) get exactly 0 weight, so the result is that of
        attending the unpadded memory. Under a head block the queries and
        the caches are the rank's heads; under a slot block x holds the
        rank's slots, ``kv_lens`` and ``page_table`` every slot's."""
        b, s, _ = x.shape
        kv_lens = slots_local(kv_lens)
        if page_table is not None:
            page_table = slots_local(page_table)
        hb = self.heads()
        q = self._proj("wq", params, x, self.n_heads, hb)
        if self.qk_norm:
            q = self.qnorm(params["qnorm"], q)
        if page_table is None:
            view_k, view_v = cache_k, cache_v
        else:
            view_k = gather_pages(cache_k, page_table)
            view_v = gather_pages(cache_v, page_table)
        t = view_k.shape[1]
        mask = (torch.arange(t, device=x.device)[None, :]
                < kv_lens[:, None])[:, None, :].expand(b, s, t)
        out = _attend_core(self._group(q), view_k, view_v, mask,
                           1.0 / math.sqrt(self.hd))
        return self._out(params, out, hb)

    # ------------------------------------------------------------------
    # int8 KV: cache {"k", "v"} int8 codes, {"ks", "vs"} f32 scales
    # ------------------------------------------------------------------
    def _write_quant(self, cache: dict, page_table, positions, k, v, valid,
                     sb: Optional[SeqBlock] = None):
        """Quantize the new K/V rows and scatter codes and scales through
        the one page table (the rank's rows under ``sb``; every slot's,
        gathered first, under a slot block); returns the per-slot views of
        all four pools (the rank's slots')."""
        k, v = _pool_rows(k, v)
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        for name, rows in (("k", kq), ("v", vq), ("ks", ks), ("vs", vs)):
            scatter_pages(cache[name], page_table, positions, rows, valid, sb)
        table = slots_local(page_table)
        return [gather_pages(cache[name], table) for name in ("k", "v", "ks", "vs")]

    def _attend_quant(self, params, q, views, mask, cd, hb, sb=None):
        """The reference's scale-factored attend, in its order of operations:
        the scales are rank-1 along hd, so they factor out of both products
        and no dequantized (B, T, K, hd) cache is built. Scores in f32,
        times ks, times 1/sqrt(hd), masked, softmax, cast to ``cd``; the
        probabilities times vs, then the product with the codes in ``cd``.
        Under a ``SeqBlock`` (the rank's codes and scales), or for a "seq"
        layer on a card, the same order in f64 (B9, ``_attend_seq``: exp(s
        - m) times vs, then the product with the codes) gives the rank's
        partial softmax, merged with the other ranks' and rounded once to
        q's dtype, ``cd``."""
        vk, vv, vks, vvs = views
        if sb is not None or self._one_part(q):
            return self._out(params, self._attend_seq(q, views, mask, sb), hb)
        scores = torch.einsum("bskgh,btkh->bkgst", self._group(q),
                              vk.to(cd)).float()
        scores = scores * vks.permute(0, 2, 1)[:, :, None, None, :]
        scores = scores * (1.0 / math.sqrt(self.hd))
        scores = torch.where(mask[:, None, None], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(cd)
        pv = probs * vvs.permute(0, 2, 1)[:, :, None, None, :].to(cd)
        out = torch.einsum("bkgst,btkh->bskgh", pv, vv.to(cd))
        return self._out(params, out, hb)

    def extend_quant(self, params: dict, x: torch.Tensor, cache: dict,
                     positions: torch.Tensor, valid: torch.Tensor,
                     page_table: torch.Tensor, seq: Optional[SeqBlock] = None
                     ) -> Tuple[torch.Tensor, dict]:
        """Chunked-prefill step against the int8 pool: the new rows are
        quantized per token and head (as a monolithic prefill would), padding
        columns never write, and the queries attend causally."""
        hb = self.heads()
        positions_l = slots_local(positions)
        q, k, v = self._qkv(params, x, positions_l, heads=hb)
        views = self._write_quant(cache, page_table, positions, k, v, valid, seq)
        k_pos = self._key_positions(views[0].shape[1], x.shape[0], seq, x.device)
        mask = make_mask(positions_l, k_pos, causal=True, window=self.window)
        return self._attend_quant(params, q, views, mask, v.dtype, hb, seq), cache

    def decode_step_quant(self, params: dict, x: torch.Tensor, cache: dict,
                          lengths: torch.Tensor,
                          page_table: Optional[torch.Tensor],
                          active: Optional[torch.Tensor] = None,
                          seq: Optional[SeqBlock] = None
                          ) -> Tuple[torch.Tensor, dict]:
        """One-token step against the int8 pool: only the new token's row is
        quantized; inactive slots drop their write. With ``page_table`` None
        the codes and scales are dense (B, T, ...) slot rows, as in
        ``decode_step``."""
        b = x.shape[0]
        lengths_l = slots_local(lengths)
        positions = lengths_l[:, None]
        hb = self.heads()
        q, k, v = self._qkv(params, x, positions, heads=hb)
        if page_table is None:
            kq, ks = quantize_kv(k[:, 0])
            vq, vs = quantize_kv(v[:, 0])
            return self._decode_dense(params, q, cache, lengths_l,
                                      {"k": kq, "v": vq, "ks": ks, "vs": vs}, hb, seq)
        ok = (torch.ones((page_table.shape[0],), dtype=torch.bool, device=x.device)
              if active is None else active)[:, None]
        views = self._write_quant(cache, page_table, lengths[:, None], k, v, ok, seq)
        k_pos = self._key_positions(views[0].shape[1], b, seq, x.device)
        mask = make_mask(positions, k_pos, causal=True, window=self.window,
                         k_valid=k_pos <= lengths_l[:, None])
        return self._attend_quant(params, q, views, mask, v.dtype, hb, seq), cache
