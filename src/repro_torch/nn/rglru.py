"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427; port
of ``repro/nn/rglru.py``).

Training runs the recurrence h_t = a_t * h_{t-1} + b_t as a log-depth
scan over time; serving keeps an ``(h, conv)`` carry per slot, advanced
one token at a time (``decode_step``) or by a chunk of columns
(``extend``).

The input, gate and output projections are TBN-tileable Dense layers; the
per-channel recurrence parameters (Lambda, conv) are small and stay f32.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.nn import module as mod
from repro_torch.nn.context import ModelContext
from repro_torch.nn.linear import Dense

_C = 8.0  # Griffin's fixed exponent scale


def _gelu(v: torch.Tensor) -> torch.Tensor:
    return F.gelu(v, approximate="tanh")      # jax.nn.gelu's default form


def _lru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t along axis 1 (h_{-1} = 0), as a log-depth
    scan: each round combines every element with the one ``d`` back,
    (a1, b1) then (a2, b2) -> (a1 a2, a2 b1 + b2)."""
    n, d = a.shape[1], 1
    while d < n:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


@dataclasses.dataclass
class RGLRUBlock:
    d_model: int
    ctx: ModelContext
    d_rnn: int = 0          # defaults to d_model
    conv_width: int = 4
    name: str = "rglru"

    def __post_init__(self):
        c = self.ctx
        self.width = self.d_rnn or self.d_model
        self.in_x = Dense(self.d_model, self.width, c, name=f"{self.name}.in_x",
                          logical=("mlp", "embed"))
        self.in_gate = Dense(self.d_model, self.width, c,
                             name=f"{self.name}.in_gate", logical=("mlp", "embed"))
        self.out = Dense(self.width, self.d_model, c, name=f"{self.name}.out",
                         logical=("embed", "mlp"))
        # the gate projections are full FC layers -> TBN-tileable
        self.w_a = Dense(self.width, self.width, c, name=f"{self.name}.w_a",
                         logical=("mlp", "mlp"))
        self.w_i = Dense(self.width, self.width, c, name=f"{self.name}.w_i",
                         logical=("mlp", "mlp"))

    def specs(self) -> mod.SpecTree:
        f32, w = torch.float32, self.width
        return {
            "in_x": self.in_x.specs(),
            "in_gate": self.in_gate.specs(),
            "out": self.out.specs(),
            "conv_w": mod.ParamSpec((self.conv_width, w), f32, (None, "mlp"),
                                    mod.normal(0.1)),
            "conv_b": mod.ParamSpec((w,), f32, ("mlp",), mod.zeros_init()),
            "lam": mod.ParamSpec((w,), f32, ("mlp",), mod.constant_init(2.2)),
            "w_a": self.w_a.specs(),
            "w_i": self.w_i.specs(),
        }

    def _gates(self, params, xi):
        """Recurrence and input gates, in f32: (a, b) with a = sigmoid(lam)
        ^ (c r) and b = sqrt(1 - a^2) * i * x."""
        xf = xi.float()
        r = torch.sigmoid(self.w_a(params["w_a"], xf).float())
        i = torch.sigmoid(self.w_i(params["w_i"], xf).float())
        log_a = _C * r * F.logsigmoid(params["lam"])
        a = torch.exp(log_a)
        b_scale = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-8))
        return a, b_scale * (i * xf)

    def _conv(self, params, x):
        xpad = F.pad(x, (0, 0, self.conv_width - 1, 0))
        w = params["conv_w"]
        return sum(xpad[:, i:i + x.shape[1], :] * w[i][None, None, :]
                   for i in range(self.conv_width)) + params["conv_b"]

    def __call__(self, params: dict, u: torch.Tensor) -> torch.Tensor:
        cd = self.ctx.compute_dtype
        xi = self._conv(params, self.in_x(params["in_x"], u))
        a, b = self._gates(params, xi)
        h = _lru_scan(a, b).to(cd)
        gate = _gelu(self.in_gate(params["in_gate"], u))
        return self.out(params["out"], h * gate)

    # ------------------------------------------------------------------
    def init_state(self, batch: int, dtype=torch.float32, device=None) -> dict:
        """Zero (h, conv window) carries, f32 whatever the compute dtype."""
        return {
            "h": torch.zeros((batch, self.width), dtype=dtype, device=device),
            "conv": torch.zeros((batch, self.conv_width - 1, self.width),
                                dtype=dtype, device=device),
        }

    def snapshot_state(self, state: dict, slot, axis: int = 0) -> dict:
        """One slot's (h, conv window) carry as a standalone tree. ``axis``
        is the slot axis (1 in a layer-stacked segment)."""
        return mod.slice_slot_rows(state, slot, axis)

    def restore_state(self, state: dict, slot, snap: dict,
                      axis: int = 0) -> dict:
        """Write a snapshot back into a slot's rows, in place: h resumes
        mid-sequence and the conv window replays the last w - 1 inputs."""
        return mod.set_slot_rows(state, slot, snap, axis)

    def extend(self, params: dict, u: torch.Tensor, state: dict,
               valid: torch.Tensor):
        """Chunked-prefill step: u (B, C, d) advances (h, conv window) by
        each row's count of valid columns. The projections and gates run
        over the whole block; only the h recurrence loops, padding columns
        leaving the carry untouched. The conv at column j reads the stored
        w - 1 deep tail plus columns <= j, so valid columns (a prefix) never
        see padding. The new tail is gathered at each row's ``n_new`` on
        the device (n_new == 0 keeps the stored tail). Returns (out, new
        state); the held state is not written."""
        b, c, _ = u.shape
        cd = self.ctx.compute_dtype
        cw = self.conv_width
        xin = self.in_x(params["in_x"], u)                       # (B, C, w)
        xcat = torch.cat([state["conv"], xin], dim=1)            # (B, w-1+C, w)
        xf = xcat.float()
        w = params["conv_w"]
        xi = sum(xf[:, i:i + c, :] * w[i][None, None, :]
                 for i in range(cw)) + params["conv_b"]
        a, bg = self._gates(params, xi)                          # (B, C, w)
        hs = state["h"].float()
        seq = []
        for t in range(c):
            hs = torch.where(valid[:, t, None], a[:, t] * hs + bg[:, t], hs)
            seq.append(hs)
        gate = _gelu(self.in_gate(params["in_gate"], u))
        y = self.out(params["out"], torch.stack(seq, dim=1).to(cd) * gate)
        n_new = valid.sum(dim=1)
        gi = n_new[:, None] + torch.arange(cw - 1, device=u.device)[None, :]
        tail = torch.gather(xf, 1, gi[:, :, None].expand(b, cw - 1, xf.shape[-1]))
        return y, {"h": hs, "conv": tail.to(state["conv"].dtype)}

    def decode_step(self, params: dict, u: torch.Tensor, state: dict):
        """u (B, 1, d) -> (y (B, 1, d), new state). The held state is not
        written."""
        cd = self.ctx.compute_dtype
        xin = self.in_x(params["in_x"], u)[:, 0]
        win = torch.cat([state["conv"], xin[:, None]], dim=1)
        xi = (torch.einsum("bwd,wd->bd", win.float(), params["conv_w"])
              + params["conv_b"])
        a, b = self._gates(params, xi)
        h = a * state["h"] + b
        gate = _gelu(self.in_gate(params["in_gate"], u)[:, 0])
        y = self.out(params["out"], (h.to(cd) * gate)[:, None])
        return y, {"h": h, "conv": win[:, 1:]}
