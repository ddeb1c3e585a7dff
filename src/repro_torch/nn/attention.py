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
from repro_torch.nn import module as mod
from repro_torch.nn.context import ModelContext
from repro_torch.nn.linear import Dense
from repro_torch.nn.norms import RMSNorm
from repro_torch.nn.rotary import apply_rope

NEG_INF = -1e30


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
                  valid: torch.Tensor) -> torch.Tensor:
    """Write cache rows at absolute ``positions`` (B, C) through the page
    table, in place. Invalid columns — padding, inactive slots, negative
    positions and positions past the table's reach — go to the scratch
    row and are never read."""
    n_rows, pt = (pool.shape[0] - 1) * pool.shape[1], pool.shape[1]
    npp = page_table.shape[1]
    flat = pool.view(-1, *pool.shape[2:])
    positions = positions.long()
    pidx = torch.div(positions, pt, rounding_mode="floor")
    page = torch.gather(page_table.long(), 1, pidx.clamp(0, npp - 1))
    ok = valid & (pidx < npp) & (positions >= 0)
    idx = torch.where(ok, page * pt + positions % pt, n_rows)
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

    def _qkv(self, params, x, positions, kv_src=None, kv_positions=None):
        """q from x; k, v from ``kv_src`` (a cross layer's memory) or x.
        RoPE at ``positions`` / ``kv_positions`` (default: ``positions``),
        never on a cross layer."""
        b, s, _ = x.shape
        src = x if kv_src is None else kv_src
        t = src.shape[1]
        q = self.wq(params["wq"], x).reshape(b, s, self.n_heads, self.hd)
        k = self.wk(params["wk"], src).reshape(b, t, self.n_kv, self.hd)
        v = self.wv(params["wv"], src).reshape(b, t, self.n_kv, self.hd)
        if self.qk_norm:
            q = self.qnorm(params["qnorm"], q)
            k = self.knorm(params["knorm"], k)
        if self.rope and not self.cross:
            q = apply_rope(q, positions, self.rope_theta)
            k = apply_rope(k, positions if kv_positions is None else kv_positions,
                           self.rope_theta)
        return q, k, v

    def _group(self, q):
        b, s = q.shape[:2]
        return q.reshape(b, s, self.n_kv, self.groups, self.hd)

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
        hd) being the cache content."""
        b, s, _ = x.shape
        if positions is None:
            positions = torch.arange(s, device=x.device).expand(b, s)
        q, k, v = self._qkv(params, x, positions)
        scale = 1.0 / math.sqrt(self.hd)
        if s >= 4 * self.q_chunk:
            out = self._chunked(q, k, v, positions, positions, scale)
        else:
            out = _attend_core(self._group(q), k, v,
                               make_mask(positions, positions,
                                         window=self.window), scale)
        y = self.wo(params["wo"], out.reshape(b, s, self.n_heads * self.hd))
        return y, (k, v)

    def _decode_dense(self, params, q, cache, lengths, rows):
        """Dense per-slot cache: write each slot's new ``rows`` at
        ``lengths`` into a copy of every leaf of ``cache`` ((B, T, ...)),
        then attend over it. Returns (y, the new cache)."""
        b = q.shape[0]
        idx = torch.arange(b, device=q.device)
        new = {}
        for name, leaf in cache.items():
            leaf = leaf.clone()
            leaf[idx, lengths.long()] = rows[name].to(leaf.dtype)
            new[name] = leaf
        t = new["k"].shape[1]
        k_pos = torch.arange(t, device=q.device).expand(b, t)
        mask = make_mask(lengths[:, None], k_pos, causal=True,
                         window=self.window, k_valid=k_pos <= lengths[:, None])
        if "ks" in new:
            views = [new[n] for n in ("k", "v", "ks", "vs")]
            return self._attend_quant(params, q, views, mask,
                                      self.ctx.compute_dtype), new
        out = _attend_core(self._group(q), new["k"], new["v"], mask,
                           1.0 / math.sqrt(self.hd))
        return self.wo(params["wo"], out.reshape(b, 1, self.n_heads * self.hd)), new

    def _attend_paged(self, params, q, cache_k, cache_v, page_table, positions,
                      k_valid=None):
        view_k = gather_pages(cache_k, page_table)
        view_v = gather_pages(cache_v, page_table)
        b, s = q.shape[:2]
        t = view_k.shape[1]
        k_pos = torch.arange(t, device=q.device).expand(b, t)
        mask = make_mask(positions, k_pos, causal=True, window=self.window,
                         k_valid=k_valid)
        out = _attend_core(self._group(q), view_k, view_v, mask,
                           1.0 / math.sqrt(self.hd))
        return self.wo(params["wo"], out.reshape(b, s, self.n_heads * self.hd))

    def decode_step(self, params: dict, x: torch.Tensor, cache_k: torch.Tensor,
                    cache_v: torch.Tensor, lengths: torch.Tensor,
                    page_table: Optional[torch.Tensor],
                    active: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One-token step: x (B, 1, d) at position ``lengths``; the new K/V
        row scatters through the table (inactive slots drop their write)
        and the attend runs over the gathered per-slot view. With
        ``page_table`` None the caches are dense (B, T, K, hd) slot rows (a
        monolithic prefill's): every slot writes its row into new tensors,
        which are returned."""
        b = x.shape[0]
        positions = lengths[:, None]
        q, k, v = self._qkv(params, x, positions)
        if page_table is None:
            y, new = self._decode_dense(params, q, {"k": cache_k, "v": cache_v},
                                        lengths, {"k": k[:, 0], "v": v[:, 0]})
            return y, new["k"], new["v"]
        ok = (torch.ones((b,), dtype=torch.bool, device=x.device)
              if active is None else active)[:, None]
        scatter_pages(cache_k, page_table, positions, k, ok)
        scatter_pages(cache_v, page_table, positions, v, ok)
        t = cache_k.shape[1] * page_table.shape[1]
        k_valid = torch.arange(t, device=x.device)[None, :] <= lengths[:, None]
        y = self._attend_paged(params, q, cache_k, cache_v, page_table,
                               positions, k_valid)
        return y, cache_k, cache_v

    def extend(self, params: dict, x: torch.Tensor, cache_k: torch.Tensor,
               cache_v: torch.Tensor, positions: torch.Tensor,
               valid: torch.Tensor, page_table: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Chunked-prefill step: column j of row b carries the token at
        ``positions[b, j]``; padding columns (valid False) never write.
        Queries attend causally over the just-updated cache."""
        q, k, v = self._qkv(params, x, positions)
        scatter_pages(cache_k, page_table, positions, k, valid)
        scatter_pages(cache_v, page_table, positions, v, valid)
        y = self._attend_paged(params, q, cache_k, cache_v, page_table, positions)
        return y, cache_k, cache_v

    # ------------------------------------------------------------------
    # cross attention (encoder-decoder serving)
    # ------------------------------------------------------------------
    def cross_kv(self, params: dict, memory: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Encoder memory (B, T, d) -> cross-attention rows k, v (B, T, K,
        hd): computed once a request in the engine's ENCODE phase and
        written into the read-only cross pool. No RoPE (cross attention is
        position-free); ``knorm`` under ``qk_norm``, as in ``_qkv``."""
        b, t, _ = memory.shape
        k = self.wk(params["wk"], memory).reshape(b, t, self.n_kv, self.hd)
        v = self.wv(params["wv"], memory).reshape(b, t, self.n_kv, self.hd)
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
        attending the unpadded memory."""
        b, s, _ = x.shape
        q = self.wq(params["wq"], x).reshape(b, s, self.n_heads, self.hd)
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
        return self.wo(params["wo"], out.reshape(b, s, self.n_heads * self.hd))

    # ------------------------------------------------------------------
    # int8 KV: cache {"k", "v"} int8 codes, {"ks", "vs"} f32 scales
    # ------------------------------------------------------------------
    def _write_quant(self, cache: dict, page_table, positions, k, v, valid):
        """Quantize the new K/V rows and scatter codes and scales through
        the one page table; returns the per-slot views of all four pools."""
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        for name, rows in (("k", kq), ("v", vq), ("ks", ks), ("vs", vs)):
            scatter_pages(cache[name], page_table, positions, rows, valid)
        return [gather_pages(cache[name], page_table)
                for name in ("k", "v", "ks", "vs")]

    def _attend_quant(self, params, q, views, mask, cd):
        """The reference's scale-factored attend, in its order of operations:
        the scales are rank-1 along hd, so they factor out of both products
        and no dequantized (B, T, K, hd) cache is built. Scores in f32,
        times ks, times 1/sqrt(hd), masked, softmax, cast to ``cd``; the
        probabilities times vs, then the product with the codes in ``cd``."""
        vk, vv, vks, vvs = views
        b, s = q.shape[:2]
        scores = torch.einsum("bskgh,btkh->bkgst", self._group(q),
                              vk.to(cd)).float()
        scores = scores * vks.permute(0, 2, 1)[:, :, None, None, :]
        scores = scores * (1.0 / math.sqrt(self.hd))
        scores = torch.where(mask[:, None, None], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(cd)
        pv = probs * vvs.permute(0, 2, 1)[:, :, None, None, :].to(cd)
        out = torch.einsum("bkgst,btkh->bskgh", pv, vv.to(cd))
        return self.wo(params["wo"], out.reshape(b, s, self.n_heads * self.hd))

    def extend_quant(self, params: dict, x: torch.Tensor, cache: dict,
                     positions: torch.Tensor, valid: torch.Tensor,
                     page_table: torch.Tensor) -> Tuple[torch.Tensor, dict]:
        """Chunked-prefill step against the int8 pool: the new rows are
        quantized per token and head (as a monolithic prefill would), padding
        columns never write, and the queries attend causally."""
        q, k, v = self._qkv(params, x, positions)
        views = self._write_quant(cache, page_table, positions, k, v, valid)
        b, t = x.shape[0], views[0].shape[1]
        k_pos = torch.arange(t, device=x.device).expand(b, t)
        mask = make_mask(positions, k_pos, causal=True, window=self.window)
        return self._attend_quant(params, q, views, mask, v.dtype), cache

    def decode_step_quant(self, params: dict, x: torch.Tensor, cache: dict,
                          lengths: torch.Tensor,
                          page_table: Optional[torch.Tensor],
                          active: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, dict]:
        """One-token step against the int8 pool: only the new token's row is
        quantized; inactive slots drop their write. With ``page_table`` None
        the codes and scales are dense (B, T, ...) slot rows, as in
        ``decode_step``."""
        b = x.shape[0]
        positions = lengths[:, None]
        q, k, v = self._qkv(params, x, positions)
        if page_table is None:
            kq, ks = quantize_kv(k[:, 0])
            vq, vs = quantize_kv(v[:, 0])
            return self._decode_dense(params, q, cache, lengths,
                                      {"k": kq, "v": vq, "ks": ks, "vs": vs})
        ok = (torch.ones((b,), dtype=torch.bool, device=x.device)
              if active is None else active)[:, None]
        views = self._write_quant(cache, page_table, positions, k, v, ok)
        t = views[0].shape[1]
        k_pos = torch.arange(t, device=x.device).expand(b, t)
        mask = make_mask(positions, k_pos, causal=True, window=self.window,
                         k_valid=k_pos <= lengths[:, None])
        return self._attend_quant(params, q, views, mask, v.dtype), cache
