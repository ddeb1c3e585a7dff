"""Mixture-of-Experts FFN: top-k routing and shared experts (port of
``repro/nn/moe.py``).

TRAIN: the sort-based capacity dispatch of the reference (GShard/MaxText
"dropped" family). Token->expert assignments are sorted by expert id
(a stable sort, as ``jnp.argsort`` is), each expert takes its first C
tokens into a dense (E, C, d) buffer (overflow dropped: zero gradient),
the expert FFNs run as one batched einsum over E and the results scatter
back weighted by the router gates. Tokens are dispatched within groups
(``MoE._n_groups``).

SERVE: the reference's drop-free, order-stable dispatch (capacity tl * k,
token-major one-hot exclusive-cumsum positions, a gate-rank-ordered
combine), so a token's output does not depend on its chunking or its
batch neighbours. Every shape is static in (tokens, E, k) and nothing
reads a device value on the host, so the engine's ticks capture as CUDA
graphs.

Beyond-paper, as in the reference: each expert's FFN matrices are
TBN-tiled *per expert* (E tiles of q bits instead of E dense expert
matrices). The routed experts run as three batched products over all E
experts on banks rebuilt from their tiles (``ExpertBank.effective``); the
reference reaches no Pallas kernel on this path and neither does the
port. Each bank is rebuilt just before its product and dropped after it,
so one bank's dense transient is alive at a time. The shared experts are
an ``MLP`` of tiled ``Dense`` layers (kernels B1-B4 on the card).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.packing import packed_len, unpack_bits
from repro_torch.core.tiling import (
    TileSpec,
    reconstruct_from_tile,
    tiled_weight,
    tiled_weight_rows,
)
from repro_torch.nn import module as mod
from repro_torch.nn.context import SERVE, ModelContext, full_f32_matmul
from repro_torch.nn.ffn import ACTIVATIONS, MLP
from repro_torch.nn.linear import bwnn_weight


def top_k_lower_first(probs: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of the last axis, ties to
    the lower index, as ``jax.lax.top_k`` orders them (``torch.topk``
    promises no order among ties)."""
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :k]
    return probs.gather(-1, idx), idx


@dataclasses.dataclass
class ExpertBank:
    """E stacked (n_out, n_in) matrices with per-expert TBN tiles."""

    n_experts: int
    n_in: int
    n_out: int
    ctx: ModelContext
    name: str = "experts"

    def __post_init__(self):
        self.spec: Optional[TileSpec] = self.ctx.policy.spec_for(
            (self.n_out, self.n_in), kind="dense")
        # the bank is E independent tiled layers for bit accounting
        for e in range(self.n_experts):
            self.ctx.note(f"{self.name}[{e}]", (self.n_out, self.n_in),
                          kind="dense", spec=self.spec)

    def specs(self) -> mod.SpecTree:
        pd, e = self.ctx.param_dtype, self.n_experts
        if self.ctx.mode == SERVE:
            if self.spec is not None and self.spec.aligned_rows:
                # row-packed per-expert tiles (E, r, words)
                return {
                    "tile": mod.ParamSpec(
                        (e, self.spec.rows_per_tile, packed_len(self.n_in)),
                        torch.int32, mod.zeros_init()),
                    "alpha": mod.ParamSpec((e, self.spec.n_alpha),
                                           torch.float32, mod.ones_init()),
                }
            if self.spec is not None:   # unaligned: flat per-expert tiles
                return {
                    "tile": mod.ParamSpec((e, packed_len(self.spec.q)),
                                          torch.int32, mod.zeros_init()),
                    "alpha": mod.ParamSpec((e, self.spec.n_alpha),
                                           torch.float32, mod.ones_init()),
                }
            return {"w": mod.ParamSpec((e, self.n_out, self.n_in),
                                       self.ctx.compute_dtype, mod.kaiming())}
        out = {"w": mod.ParamSpec((e, self.n_out, self.n_in), pd, mod.kaiming())}
        if self.spec is not None and self.spec.alpha_source == "A":
            out["a"] = mod.ParamSpec((e, self.n_out, self.n_in), pd,
                                     mod.kaiming())
        return out

    def effective(self, params: dict) -> torch.Tensor:
        """(E, n_out, n_in) effective weights in the compute dtype."""
        cd, spec = self.ctx.compute_dtype, self.spec
        if self.ctx.mode == SERVE:
            if spec is None:
                return params["w"].to(cd)
            tile = params["tile"]
            if tile.ndim == 3:          # row-packed (E, r, words)
                t = unpack_bits(tile, self.n_in, dtype=cd).reshape(
                    self.n_experts, spec.q)
            else:                       # flat (E, ceil(q/32))
                t = unpack_bits(tile, spec.q, dtype=cd)
            return reconstruct_from_tile(t, params["alpha"], spec, dtype=cd)
        w = params["w"]
        if spec is not None:
            a = params.get("a")
            if spec.aligned_rows:
                return tiled_weight_rows(w, spec, a=a, dtype=cd)
            per = [tiled_weight(we, spec, a=None if a is None else a[i], dtype=cd)
                   for i, we in enumerate(w.unbind(0))]
            return torch.stack(per).reshape(self.n_experts, self.n_out, self.n_in)
        if self.ctx.policy.binarize("dense"):
            return torch.stack([bwnn_weight(we, cd) for we in w.unbind(0)])
        return w.to(cd)


@dataclasses.dataclass
class MoE:
    """Top-k routed MoE layer with optional shared experts."""

    d_model: int
    d_ff: int                    # per-expert hidden
    n_experts: int
    top_k: int
    ctx: ModelContext
    n_shared: int = 0            # shared experts (always on), d_ff each
    name: str = "moe"
    capacity_factor: float = 1.25
    gated: bool = True           # SwiGLU experts
    activation: str = "silu"

    def __post_init__(self):
        c = self.ctx
        self.up = ExpertBank(self.n_experts, self.d_model, self.d_ff, c,
                             name=f"{self.name}.up")
        if self.gated:
            self.gate_bank = ExpertBank(self.n_experts, self.d_model, self.d_ff,
                                        c, name=f"{self.name}.gate")
        self.down = ExpertBank(self.n_experts, self.d_ff, self.d_model, c,
                               name=f"{self.name}.down")
        if self.n_shared:
            self.shared = MLP(self.d_model, self.d_ff * self.n_shared, c,
                              name=f"{self.name}.shared", gated=self.gated,
                              activation=self.activation)
        # the router stays f32 (below lambda)
        c.note(f"{self.name}.router", (self.n_experts, self.d_model),
               kind="norm", spec=None)
        self._act = ACTIVATIONS[self.activation]

    def specs(self) -> mod.SpecTree:
        out = {
            "router": mod.ParamSpec((self.n_experts, self.d_model),
                                    torch.float32, mod.normal(0.02)),
            "up": self.up.specs(),
            "down": self.down.specs(),
        }
        if self.gated:
            out["gate"] = self.gate_bank.specs()
        if self.n_shared:
            out["shared"] = self.shared.specs()
        return out

    def _route(self, router: torch.Tensor, xg: torch.Tensor):
        """f32 router over the last axis of xg (..., d) -> (probs (..., E),
        gates (..., k) renormalised to sum 1, expert ids (..., k))."""
        with full_f32_matmul():
            logits = xg.float() @ router.T
        probs = torch.softmax(logits, dim=-1)
        gate_vals, top_idx = top_k_lower_first(probs, self.top_k)
        gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
        return probs, gate_vals, top_idx

    def _bank_product(self, buf: torch.Tensor, bank: ExpertBank,
                      params: dict) -> torch.Tensor:
        """(E, c, n_in) x bank (E, n_out, n_in) -> (E, c, n_out): the
        reference's ``einsum("ecd,efd->ecf")``, the bank rebuilt for it."""
        return torch.bmm(buf, bank.effective(params).transpose(1, 2))

    # ---------------- training dispatch ----------------
    def _n_groups(self, t_tokens: int) -> int:
        """Dispatch groups: tokens are routed, sorted and scattered within a
        group (the reference shards groups over its mesh). One group below
        8192 tokens."""
        for g in (512, 256, 64, 32, 16, 8):
            if t_tokens % g == 0 and t_tokens >= g * 1024:
                return g
        return 1

    def _capacity(self, tl: int) -> int:
        cap = int(math.ceil(self.capacity_factor * self.top_k * tl
                            / self.n_experts))
        return max(8, -(-cap // 8) * 8)

    def _dispatch(self, xg, top_idx, gate_vals, cap):
        """One group's dense dispatch. xg (tl, d); top_idx / gate_vals
        (tl, k). Returns xbuf (E, cap, d) and (e_idx, pos_c, tok_of, gates)
        for the combine. An over-capacity assignment gets expert id E: its
        scatter lands in a spare row that is cut off, its gate is 0."""
        cd = self.ctx.compute_dtype
        tl, d = xg.shape
        e, k = self.n_experts, self.top_k
        dev = xg.device
        flat_e = top_idx.reshape(-1)                              # (tl*k,)
        flat_g = gate_vals.reshape(-1).to(cd)
        order = torch.argsort(flat_e, stable=True)
        tok_of = order // k
        e_sorted = flat_e[order]
        counts = torch.zeros((e,), dtype=flat_e.dtype, device=dev).scatter_add_(
            0, flat_e, torch.ones_like(flat_e))
        starts = counts.cumsum(0) - counts
        pos = torch.arange(tl * k, device=dev) - starts[e_sorted]
        keep = (pos >= 0) & (pos < cap)
        e_idx = torch.where(keep, e_sorted, torch.full_like(e_sorted, e))
        pos_c = pos.clamp(0, cap - 1)
        gates = torch.where(keep, flat_g[order], torch.zeros_like(flat_g))
        # k-chunked scatter: one (tl, d) gather + scatter per top-k slot
        xbuf = torch.zeros((e + 1, cap, d), dtype=cd, device=dev)
        for j in range(k):
            sl = slice(j * tl, (j + 1) * tl)
            xbuf = xbuf.index_put((e_idx[sl], pos_c[sl]),
                                  xg[tok_of[sl]].to(cd), accumulate=True)
        return xbuf[:e], (e_idx, pos_c, tok_of, gates)

    def _combine(self, ybuf, meta, tl):
        e_idx, pos_c, tok_of, gates = meta
        d = ybuf.shape[-1]
        # a zero row at index E: a dropped assignment gathers exact zeros
        padded = torch.cat([ybuf, ybuf.new_zeros((1,) + tuple(ybuf.shape[1:]))])
        y = ybuf.new_zeros((tl, d))
        for j in range(self.top_k):
            sl = slice(j * tl, (j + 1) * tl)
            yj = padded[e_idx[sl], pos_c[sl]]
            y = y.index_add(0, tok_of[sl], yj * gates[sl, None])
        return y

    # ---------------- serving dispatch ----------------
    def _dispatch_serve(self, xg, top_idx):
        """Drop-free, order-stable dispatch for the serving tick: capacity
        tl * k (nothing can drop), and each assignment's position in its
        expert from a token-major one-hot exclusive cumsum, so slot (t, j)
        gets a cell that depends on tokens 0..t only. Every cell holds one
        token, so the scatter is a copy with no add order. Returns xbuf
        (E, tl*k, d) and (expert ids, positions), both (tl*k,)."""
        cd = self.ctx.compute_dtype
        tl, d = xg.shape
        e, k = self.n_experts, self.top_k
        cap = tl * k
        flat_e = top_idx.reshape(-1)                    # token-major (tl*k,)
        onehot = F.one_hot(flat_e, num_classes=e)
        pos = (onehot.cumsum(0) - onehot).gather(1, flat_e[:, None])[:, 0]
        src = xg.to(cd)[:, None, :].expand(tl, k, d).reshape(cap, d)
        xbuf = torch.zeros((e * cap, d), dtype=cd, device=xg.device)
        xbuf.index_copy_(0, flat_e * cap + pos, src)
        return xbuf.view(e, cap, d), (flat_e, pos)

    def _combine_serve(self, ybuf, meta, gate_vals, tl):
        """Gate-rank-order combine: token t's output is the ordered sum over
        j = 0..k-1 of gate[t, j] * ybuf[e(t, j), pos(t, j)], in the compute
        dtype (a fixed-length, fixed-order accumulation per token)."""
        cd = self.ctx.compute_dtype
        flat_e, pos = meta
        k, cap, d = self.top_k, ybuf.shape[1], ybuf.shape[-1]
        rows = ybuf.reshape(-1, d)
        y = torch.zeros((tl, d), dtype=cd, device=ybuf.device)
        for j in range(k):
            y = y + rows[flat_e[j::k] * cap + pos[j::k]] * gate_vals[:, j, None].to(cd)
        return y

    def _serve_call(self, params: dict, x: torch.Tensor):
        """Fixed-shape serving forward: drop-free dispatch, one dispatch
        group, expert banks rebuilt from their packed tiles."""
        b, s, d = x.shape
        tl = b * s
        xg = x.reshape(tl, d)
        _, gate_vals, top_idx = self._route(params["router"], xg)
        xbuf, meta = self._dispatch_serve(xg, top_idx)      # (E, tl*k, d)
        h = self._bank_product(xbuf, self.up, params["up"])
        if self.gated:
            h = self._act(self._bank_product(xbuf, self.gate_bank,
                                             params["gate"])) * h
        else:
            h = self._act(h)
        ybuf = self._bank_product(h, self.down, params["down"])
        y = self._combine_serve(ybuf, meta, gate_vals, tl)
        if self.n_shared:
            y = y + self.shared(params["shared"], xg[None])[0]
        return (y.reshape(b, s, d),
                torch.zeros((), dtype=torch.float32, device=x.device))

    def __call__(self, params: dict, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (output (B, S, d), Switch load-balance aux loss)."""
        if self.ctx.mode == SERVE:
            return self._serve_call(params, x)
        b, s, d = x.shape
        g = self._n_groups(b * s)
        tl = b * s // g
        xg = x.reshape(g, tl, d)
        probs, gate_vals, top_idx = self._route(params["router"], xg)
        # Switch-style load balance aux (over all tokens)
        density = F.one_hot(top_idx[..., 0], num_classes=self.n_experts
                            ).float().mean(dim=(0, 1))
        aux = self.n_experts * (density * probs.mean(dim=(0, 1))).sum()

        cap = self._capacity(tl)
        groups = [self._dispatch(xg[i], top_idx[i], gate_vals[i], cap)
                  for i in range(g)]
        xbuf = torch.stack([buf for buf, _ in groups])      # (g, E, cap, d)
        w_up = self.up.effective(params["up"])
        h = torch.einsum("gecd,efd->gecf", xbuf, w_up)
        if self.gated:
            w_gate = self.gate_bank.effective(params["gate"])
            h = self._act(torch.einsum("gecd,efd->gecf", xbuf, w_gate)) * h
        else:
            h = self._act(h)
        w_down = self.down.effective(params["down"])
        ybuf = torch.einsum("gecf,edf->gecd", h, w_down)
        yg = torch.stack([self._combine(ybuf[i], meta, tl)
                          for i, (_, meta) in enumerate(groups)])
        if self.n_shared:
            yg = yg + self.shared(params["shared"], xg)
        return yg.reshape(b, s, d), aux
