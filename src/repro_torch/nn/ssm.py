"""Mamba2 (SSD, state-space duality) block, chunked matmul formulation
(port of ``repro/nn/ssm.py``).

arXiv:2405.21060: the sequence is split into chunks; intra-chunk terms are
dense products (quadratic in the chunk), the inter-chunk state is a short
loop over chunk boundaries. Serving keeps an O(1) ``(h, conv)`` carry per
slot: ``extend`` and ``decode_step`` run exactly the same per-token update
on it, so any chunking of a token stream walks the carry through the same
values.

TBN applies to the in/out projections (>= lambda); the SSD parameters (A,
D, dt bias, conv) are small and stay f32. The f32 products run with TF32
off, as the reference's f32 dots run at full precision.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.nn import module as mod
from repro_torch.nn.context import ModelContext, full_f32_matmul
from repro_torch.nn.linear import Dense


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., q) -> (..., q, q) lower-triangular segment sums:
    out[i, j] = sum_{k=j+1..i} x[k] (i >= j), -inf above the diagonal."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, -torch.inf)


def _repeat(x: torch.Tensor, rep: int, dim: int) -> torch.Tensor:
    """Each entry along ``dim`` repeated ``rep`` times in place
    (``jnp.repeat``), as a broadcast view and one copy: no host read."""
    dim %= x.dim()
    shape = list(x.shape)
    shape.insert(dim + 1, rep)
    return x.unsqueeze(dim + 1).expand(shape).flatten(dim, dim + 1)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) with no linear cut-off (``jax.nn.softplus``;
    ``F.softplus`` returns x itself above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def gated_rms_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                   cd) -> torch.Tensor:
    """mamba2's norm before out_proj: y * silu(z), RMS-normalized in f32."""
    y = y * F.silu(z)
    var = y.float().square().mean(dim=-1, keepdim=True)
    return (y.float() * torch.rsqrt(var + 1e-6) * scale).to(cd)


@dataclasses.dataclass
class Mamba2Block:
    d_model: int
    ctx: ModelContext
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 256
    name: str = "mamba2"

    def __post_init__(self):
        c = self.ctx
        self.d_inner = self.expand * self.d_model
        assert self.d_inner % self.head_dim == 0
        self.n_heads = self.d_inner // self.head_dim
        self.d_conv = self.d_inner + 2 * self.n_groups * self.d_state
        d_in_proj = (2 * self.d_inner + 2 * self.n_groups * self.d_state
                     + self.n_heads)
        self.in_proj = Dense(self.d_model, d_in_proj, c,
                             name=f"{self.name}.in_proj", logical=("mlp", "embed"))
        self.out_proj = Dense(self.d_inner, self.d_model, c,
                              name=f"{self.name}.out_proj", logical=("embed", "mlp"))

    def specs(self) -> mod.SpecTree:
        f32 = torch.float32
        return {
            "in_proj": self.in_proj.specs(),
            "out_proj": self.out_proj.specs(),
            "conv_w": mod.ParamSpec((self.conv_width, self.d_conv), f32,
                                    (None, "mlp"), mod.normal(0.1)),
            "conv_b": mod.ParamSpec((self.d_conv,), f32, ("mlp",),
                                    mod.zeros_init()),
            "A_log": mod.ParamSpec((self.n_heads,), f32, (None,), mod.zeros_init()),
            "D": mod.ParamSpec((self.n_heads,), f32, (None,), mod.ones_init()),
            "dt_bias": mod.ParamSpec((self.n_heads,), f32, (None,),
                                     mod.zeros_init()),
            "norm_scale": mod.ParamSpec((self.d_inner,), f32, ("mlp",),
                                        mod.ones_init()),
        }

    # ------------------------------------------------------------------
    def _split(self, zxbcdt):
        """-> z (.., d_inner), the pre-conv (x, B, C) (.., d_conv), dt
        (.., n_heads)."""
        di = self.d_inner
        return (zxbcdt[..., :di], zxbcdt[..., di:di + self.d_conv],
                zxbcdt[..., di + self.d_conv:])

    def _conv(self, params, xc):
        """Causal depthwise conv over time (width conv_width), then silu."""
        w = params["conv_w"]
        xpad = F.pad(xc, (0, 0, self.conv_width - 1, 0))
        out = sum(xpad[:, i:i + xc.shape[1], :] * w[i][None, None, :]
                  for i in range(self.conv_width))
        return F.silu(out + params["conv_b"])

    def _ssd(self, x, dt, A, B, C):
        """Chunked SSD scan. x (b, l, h, p); dt (b, l, h); A (h,); B, C
        (b, l, g, n). Returns y (b, l, h, p) and the final state (b, h, p, n).
        The chunk shrinks until it divides l (a prime l runs q = 1)."""
        b, l, h, p = x.shape
        g, n = B.shape[2], B.shape[3]
        q = min(self.chunk, l)
        while l % q:
            q -= 1
        nc = l // q
        rep = h // g

        xc = x.reshape(b, nc, q, h, p)
        dtc = dt.reshape(b, nc, q, h)
        Bc = _repeat(B.reshape(b, nc, q, g, n), rep, 3)
        Cc = _repeat(C.reshape(b, nc, q, g, n), rep, 3)

        dA = (dtc * A[None, None, None, :]).movedim(-1, -2)   # (b,nc,h,q)
        A_cum = torch.cumsum(dA, dim=-1)

        with full_f32_matmul():
            # intra-chunk (diagonal block) output
            L = torch.exp(_segsum(dA))                         # (b,nc,h,q,q)
            xdt = xc * dtc[..., None]
            Ydiag = torch.einsum("bzihn,bzjhn,bzhij,bzjhp->bzihp",
                                 Cc, Bc, L, xdt)
            # per-chunk final states
            decay_to_end = torch.exp(A_cum[..., -1:] - A_cum)  # (b,nc,h,q)
            states = torch.einsum("bzjhn,bzhj,bzjhp->bzhpn",
                                  Bc, decay_to_end, xdt)
            # inter-chunk recurrence over the nc chunk boundaries
            chunk_decay = torch.exp(A_cum[..., -1])            # (b,nc,h)
            hcur = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
            hprevs = []
            for z in range(nc):
                hprevs.append(hcur)
                hcur = hcur * chunk_decay[:, z, :, None, None] + states[:, z]
            hprev = torch.stack(hprevs, dim=1)                 # (b,nc,h,p,n)
            # off-diagonal: the carried-in state's contribution
            Yoff = torch.einsum("bzihn,bzhpn,bzhi->bzihp",
                                Cc, hprev, torch.exp(A_cum))
        return (Ydiag + Yoff).reshape(b, l, h, p), hcur

    # ------------------------------------------------------------------
    def __call__(self, params: dict, u: torch.Tensor) -> torch.Tensor:
        return self.forward_with_state(params, u)[0]

    def forward_with_state(self, params: dict, u: torch.Tensor):
        """u (b, l, d_model) -> (out, {"h": final SSD state, "conv": the last
        w - 1 pre-conv inputs in f32, zero-padded in front when l < w - 1})."""
        b, l, _ = u.shape
        cd = self.ctx.compute_dtype
        di, g, n, h = self.d_inner, self.n_groups, self.d_state, self.n_heads
        z, xc_raw, dt_raw = self._split(self.in_proj(params["in_proj"], u))
        tail = xc_raw[:, -(self.conv_width - 1):, :].float()
        pad = self.conv_width - 1 - tail.shape[1]
        if pad > 0:
            tail = F.pad(tail, (0, 0, pad, 0))
        xc = self._conv(params, xc_raw)
        x = xc[..., :di].reshape(b, l, h, self.head_dim)
        Bm = xc[..., di:di + g * n].reshape(b, l, g, n)
        Cm = xc[..., di + g * n:].reshape(b, l, g, n)
        dt = softplus(dt_raw.float() + params["dt_bias"])
        A = -torch.exp(params["A_log"])
        y, state = self._ssd(x.float(), dt, A, Bm.float(), Cm.float())
        y = y + params["D"][None, None, :, None] * x.float()
        y = gated_rms_norm(y.reshape(b, l, di).to(cd), z,
                           params["norm_scale"], cd)
        return self.out_proj(params["out_proj"], y), {"h": state, "conv": tail}

    # ------------------------------------------------------------------
    def init_state(self, batch: int, dtype=torch.float32, device=None) -> dict:
        """Zero (h, conv) carries, f32 whatever the compute dtype."""
        return {
            "h": torch.zeros((batch, self.n_heads, self.head_dim, self.d_state),
                             dtype=dtype, device=device),
            "conv": torch.zeros((batch, self.conv_width - 1, self.d_conv),
                                dtype=dtype, device=device),
        }

    def snapshot_state(self, state: dict, slot, axis: int = 0) -> dict:
        """One slot's (h, conv) carry as a standalone tree: the SSM state at
        a prefix boundary is the whole prefix. ``axis`` is the slot axis (1
        in a layer-stacked segment)."""
        return mod.slice_slot_rows(state, slot, axis)

    def restore_state(self, state: dict, slot, snap: dict,
                      axis: int = 0) -> dict:
        """Write a snapshot back into a slot's rows, in place."""
        return mod.set_slot_rows(state, slot, snap, axis)

    def _step(self, params, hs, conv, xc_t, dt_t):
        """One token's update of the (h, conv) carry: xc_t (B, d_conv) and
        dt_t (B, n_heads) pre-conv inputs -> (y (B, h, p) f32, new h, the
        conv window (B, w, d_conv) whose last w - 1 rows are the new conv)."""
        b = xc_t.shape[0]
        di, g, n, h = self.d_inner, self.n_groups, self.d_state, self.n_heads
        rep = h // g
        # torch.cat promotes a bf16 input to the f32 carry's dtype
        win = torch.cat([conv, xc_t[:, None, :]], dim=1)
        xc = F.silu(torch.einsum("bwd,wd->bd", win.float(), params["conv_w"])
                    + params["conv_b"])
        x = xc[..., :di].reshape(b, h, self.head_dim)
        Bm = _repeat(xc[..., di:di + g * n].reshape(b, g, n), rep, 1)
        Cm = _repeat(xc[..., di + g * n:].reshape(b, g, n), rep, 1)
        dt = softplus(dt_t.float() + params["dt_bias"])            # (b, h)
        decay = torch.exp(dt * -torch.exp(params["A_log"]))[..., None, None]
        h_upd = hs * decay + (dt[:, :, None, None] * Bm[:, :, None, :]
                              * x[:, :, :, None])
        y = torch.einsum("bhn,bhpn->bhp", Cm, h_upd)
        y = y + params["D"][None, :, None] * x
        return y, h_upd, win

    def extend(self, params: dict, u: torch.Tensor, state: dict,
               valid: torch.Tensor):
        """Chunked-prefill step: u (B, C, d_model) advances the carry by each
        row's count of valid columns. The projections run once over the
        block (the m = B * C product); the recurrence is a loop of exactly
        ``decode_step``'s update, and padding columns (valid False) leave
        (h, conv) untouched through ``torch.where``. Returns (out, new
        state); the held state is not written."""
        b, c, _ = u.shape
        cd = self.ctx.compute_dtype
        z, xc_new, dt_raw = self._split(self.in_proj(params["in_proj"], u))
        hs, conv = state["h"], state["conv"]
        ys = []
        with full_f32_matmul():
            for t in range(c):
                y, h_upd, win = self._step(params, hs, conv, xc_new[:, t],
                                           dt_raw[:, t])
                v_t = valid[:, t]
                hs = torch.where(v_t[:, None, None, None], h_upd, hs)
                conv = torch.where(v_t[:, None, None], win[:, 1:], conv)
                ys.append(y.reshape(b, self.d_inner))
        y = gated_rms_norm(torch.stack(ys, dim=1).to(cd), z,
                           params["norm_scale"], cd)
        return self.out_proj(params["out_proj"], y), {"h": hs, "conv": conv}

    def decode_step(self, params: dict, u: torch.Tensor, state: dict):
        """u (B, 1, d_model) -> (out (B, 1, d_model), new state): the O(1)
        recurrent update. The held state is not written."""
        b = u.shape[0]
        cd = self.ctx.compute_dtype
        z, xc_new, dt_raw = self._split(self.in_proj(params["in_proj"], u)[:, 0])
        with full_f32_matmul():
            y, hstate, win = self._step(params, state["h"], state["conv"],
                                        xc_new, dt_raw)
        y = gated_rms_norm(y.reshape(b, self.d_inner).to(cd), z,
                           params["norm_scale"], cd)
        out = self.out_proj(params["out_proj"], y[:, None, :])
        return out, {"h": hstate, "conv": win[:, 1:]}
