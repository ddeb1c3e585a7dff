"""Multi-head attention serve paths: GQA, RoPE, paged bf16/f32 KV pool
(port of the serving half of ``repro/nn/attention.py``).

The softmax core is written in plain torch ops, as the reference writes it
in jnp, so the parity tests compare like with like. The int8 KV path and
the dense (unpaged) cache wait for later slices.

Paged pool layout: a cache leaf is ``(n_pages + 1, page_tokens, K, hd)``.
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

from repro_torch.nn import module as mod
from repro_torch.nn.context import ModelContext
from repro_torch.nn.linear import Dense
from repro_torch.nn.norms import RMSNorm
from repro_torch.nn.rotary import apply_rope

NEG_INF = -1e30


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
    or (S, T), True = attend -> (B, S, K, G, hd)."""
    scores = torch.einsum("bskgh,btkh->bkgst", q, k).float() * scale
    mask_b = mask[None, None, None] if mask.ndim == 2 else mask[:, None, None]
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

    def __post_init__(self):
        self.hd = self.head_dim or self.d_model // self.n_heads
        assert self.n_heads % self.n_kv == 0
        self.groups = self.n_heads // self.n_kv
        c, d, hd = self.ctx, self.d_model, self.hd
        self.wq = Dense(d, self.n_heads * hd, c, name=f"{self.name}.wq",
                        use_bias=self.qkv_bias)
        self.wk = Dense(d, self.n_kv * hd, c, name=f"{self.name}.wk",
                        use_bias=self.qkv_bias)
        self.wv = Dense(d, self.n_kv * hd, c, name=f"{self.name}.wv",
                        use_bias=self.qkv_bias)
        self.wo = Dense(self.n_heads * hd, d, c, name=f"{self.name}.wo")
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

    def _qkv(self, params, x, positions):
        b, s, _ = x.shape
        q = self.wq(params["wq"], x).reshape(b, s, self.n_heads, self.hd)
        k = self.wk(params["wk"], x).reshape(b, s, self.n_kv, self.hd)
        v = self.wv(params["wv"], x).reshape(b, s, self.n_kv, self.hd)
        if self.qk_norm:
            q = self.qnorm(params["qnorm"], q)
            k = self.knorm(params["knorm"], k)
        if self.rope:
            q = apply_rope(q, positions, self.rope_theta)
            k = apply_rope(k, positions, self.rope_theta)
        return q, k, v

    def _group(self, q):
        b, s = q.shape[:2]
        return q.reshape(b, s, self.n_kv, self.groups, self.hd)

    def _attend_paged(self, params, q, cache_k, cache_v, page_table, positions,
                      k_valid=None):
        view_k = gather_pages(cache_k, page_table)
        view_v = gather_pages(cache_v, page_table)
        b, s = q.shape[:2]
        t = view_k.shape[1]
        k_pos = torch.arange(t, device=q.device).expand(b, t)
        mask = make_mask(positions, k_pos, causal=True, k_valid=k_valid)
        out = _attend_core(self._group(q), view_k, view_v, mask,
                           1.0 / math.sqrt(self.hd))
        return self.wo(params["wo"], out.reshape(b, s, self.n_heads * self.hd))

    def decode_step(self, params: dict, x: torch.Tensor, cache_k: torch.Tensor,
                    cache_v: torch.Tensor, lengths: torch.Tensor,
                    page_table: torch.Tensor,
                    active: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One-token step: x (B, 1, d) at position ``lengths``; the new K/V
        row scatters through the table (inactive slots drop their write)
        and the attend runs over the gathered per-slot view."""
        b = x.shape[0]
        positions = lengths[:, None]
        q, k, v = self._qkv(params, x, positions)
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
