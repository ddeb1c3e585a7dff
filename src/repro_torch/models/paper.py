"""The paper's own evaluation architectures on the TBN substrate (port of
``repro/models/paper.py``).

Exact layer shapes (the bit accounting of the paper's tables depends only
on them) and runnable forward paths. Every ``Conv2D`` / ``Dense`` consults
the model's TBNPolicy, so one ``policy=`` switch gives the FP32 / BWNN /
TBN_p variants. Activations are NHWC (images) or (B, tokens, features),
as in the reference; param trees have the reference's keys (``s2b0.c1``).

Families:  ResNet-18/34/50, VGG-Small     (Table 1/2)
           PointNet (cls / part / sem)    (Table 3)
           ViT, Swin-lite                 (Table 4)
           TS-Transformer encoder         (Table 5)
           MCU-MLP 784-128-10             (Table 6)
           MLPMixer, ConvMixer            (Fig. 6/7)

Max pools pad by the reference's asymmetric SAME rule with -inf
(``kernels.ops.pad_nhwc``), not PyTorch's symmetric padding.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.tiling import tiled_weight
from repro_torch.kernels.ops import pad_nhwc
from repro_torch.nn import module as mod
from repro_torch.nn.context import ModelContext
from repro_torch.nn.ffn import ACTIVATIONS
from repro_torch.nn.linear import Conv2D, Dense
from repro_torch.nn.norms import LayerNorm

gelu = ACTIVATIONS["gelu"]      # jax.nn.gelu's default (tanh) form


# ---------------------------------------------------------------------------
# small helpers
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ChannelNorm:
    """LayerNorm over the channel axis (BN stand-in; never quantized)."""

    dim: int
    ctx: ModelContext
    name: str = "cnorm"

    def __post_init__(self):
        self.ln = LayerNorm(self.dim, self.ctx, name=self.name)

    def specs(self):
        return self.ln.specs()

    def __call__(self, params, x):
        return self.ln(params, x)


def _dense(*args, **kw) -> Dense:
    """A ``Dense`` that names no logical axis: the paper's models shard
    nothing over a mesh (the reference's ``logical=(None, None)``)."""
    return Dense(*args, logical=(None, None), **kw)


class _Seq:
    """Name -> module container with dict specs/params."""

    def __init__(self):
        self._mods = {}

    def add(self, name, m):
        self._mods[name] = m
        return m

    def specs(self):
        return {k: m.specs() for k, m in self._mods.items()}

    def __getitem__(self, k):
        return self._mods[k]

    def items(self):
        return self._mods.items()


class _PaperModel:
    """Shared ``specs`` / ``init`` of the builders below."""

    ctx: ModelContext
    m: _Seq

    def specs(self):
        return self.m.specs()

    def init(self, seed: int) -> dict:
        return mod.init_params(self.specs(), seed, self.ctx.device)


def max_pool_nhwc(x: torch.Tensor, window: int, stride: int, padding: str
                  ) -> torch.Tensor:
    """``reduce_window(max)`` over H and W of NHWC x, padded with -inf by
    the reference's rule (SAME puts the odd pixel at the high end)."""
    x = pad_nhwc(x, (window, window), (stride, stride), padding,
                 value=float("-inf"))
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1)


def _patches(x: torch.Tensor, img: int, p: int) -> torch.Tensor:
    """(B, img, img, 3) -> (B, (img/p)^2, p*p*3) non-overlapping patches."""
    b, n = x.shape[0], img // p
    x = x.reshape(b, n, p, n, p, 3).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, n * n, p * p * 3)


def _attend(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Full softmax attention of a fused (B, T, 3d) projection -> (B, T, d)."""
    b, _, d3 = qkv.shape
    d = d3 // 3
    hd = d // heads
    q, k, v = (t.reshape(b, -1, heads, hd) for t in qkv.chunk(3, dim=-1))
    att = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    att = torch.softmax(att, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(b, -1, d)


# ---------------------------------------------------------------------------
# ResNet / VGG (Table 1, 2)
# ---------------------------------------------------------------------------
class ResNet(_PaperModel):
    """CIFAR-style (3x3 stem) or ImageNet-style (7x7 stem + max pool)."""

    CFG = {
        18: ("basic", (2, 2, 2, 2)),
        34: ("basic", (3, 4, 6, 3)),
        50: ("bottleneck", (3, 4, 6, 3)),
    }

    def __init__(self, depth: int, ctx: ModelContext, *, classes=10,
                 imagenet=False, width=64):
        self.ctx = ctx
        self.classes = classes
        self.imagenet = imagenet
        kind, blocks = self.CFG[depth]
        self.kind = kind
        self.expansion = 4 if kind == "bottleneck" else 1
        m = self.m = _Seq()
        if imagenet:
            m.add("stem", Conv2D(3, width, (7, 7), ctx, stride=(2, 2),
                                 name="stem"))
        else:
            m.add("stem", Conv2D(3, width, (3, 3), ctx, name="stem"))
        m.add("stem_norm", ChannelNorm(width, ctx, name="stem_norm"))
        c_in = width
        self.block_names: List[Tuple[str, int, int, int]] = []
        for stage, n in enumerate(blocks):
            c_mid = width * (2 ** stage)
            stride = 1 if stage == 0 else 2
            for b in range(n):
                s = stride if b == 0 else 1
                name = f"s{stage}b{b}"
                self._add_block(name, c_in, c_mid, s)
                c_in = c_mid * self.expansion
                self.block_names.append((name, c_mid, s, c_in))
        m.add("head", _dense(c_in, classes, ctx, name="head", kind="head"))

    def _add_block(self, name, c_in, c_mid, stride):
        ctx, m = self.ctx, self.m
        st = (stride, stride)
        if self.kind == "basic":
            m.add(f"{name}.c1", Conv2D(c_in, c_mid, (3, 3), ctx, stride=st,
                                       name=f"{name}.c1"))
            m.add(f"{name}.n1", ChannelNorm(c_mid, ctx))
            m.add(f"{name}.c2", Conv2D(c_mid, c_mid, (3, 3), ctx,
                                       name=f"{name}.c2"))
            m.add(f"{name}.n2", ChannelNorm(c_mid, ctx))
            c_out = c_mid
        else:
            m.add(f"{name}.c1", Conv2D(c_in, c_mid, (1, 1), ctx,
                                       name=f"{name}.c1"))
            m.add(f"{name}.n1", ChannelNorm(c_mid, ctx))
            m.add(f"{name}.c2", Conv2D(c_mid, c_mid, (3, 3), ctx, stride=st,
                                       name=f"{name}.c2"))
            m.add(f"{name}.n2", ChannelNorm(c_mid, ctx))
            m.add(f"{name}.c3", Conv2D(c_mid, c_mid * 4, (1, 1), ctx,
                                       name=f"{name}.c3"))
            m.add(f"{name}.n3", ChannelNorm(c_mid * 4, ctx))
            c_out = c_mid * 4
        if stride != 1 or c_in != c_out:
            m.add(f"{name}.down", Conv2D(c_in, c_out, (1, 1), ctx, stride=st,
                                         name=f"{name}.down"))

    def _conv_norm(self, params, block: str, i: int, x):
        """The block's i-th conv, then its i-th norm."""
        c, n = f"{block}.c{i}", f"{block}.n{i}"
        return self.m[n](params[n], self.m[c](params[c], x))

    def __call__(self, params, x):
        m = self.m
        h = m["stem"](params["stem"], x)
        if self.imagenet:
            h = max_pool_nhwc(h, 3, 2, "SAME")
        h = F.relu(m["stem_norm"](params["stem_norm"], h))
        for name, _, _, _ in self.block_names:
            h2 = self._conv_norm(params, name, 1, h)
            for i in (2, 3) if self.kind == "bottleneck" else (2,):
                h2 = self._conv_norm(params, name, i, F.relu(h2))
            idn = h
            if f"{name}.down" in params:
                idn = m[f"{name}.down"](params[f"{name}.down"], idn)
            h = F.relu(idn + h2)
        return m["head"](params["head"], h.mean(dim=(1, 2)))


class VGGSmall(_PaperModel):
    """The binary-nets VGG-Small: 6 convs (128..512) + classifier."""

    def __init__(self, ctx: ModelContext, classes=10):
        self.ctx = ctx
        m = self.m = _Seq()
        chans = [(3, 128), (128, 128), (128, 256), (256, 256),
                 (256, 512), (512, 512)]
        for i, (ci, co) in enumerate(chans):
            m.add(f"c{i}", Conv2D(ci, co, (3, 3), ctx, name=f"c{i}"))
            m.add(f"n{i}", ChannelNorm(co, ctx))
        m.add("head", _dense(512 * 4 * 4, classes, ctx, name="head", kind="head"))

    def __call__(self, params, x):
        h = x
        for i in range(6):
            h = self.m[f"c{i}"](params[f"c{i}"], h)
            h = F.relu(self.m[f"n{i}"](params[f"n{i}"], h))
            if i % 2 == 1:  # pool after every pair: 32 -> 16 -> 8 -> 4
                h = max_pool_nhwc(h, 2, 2, "VALID")
        h = h.reshape(h.shape[0], -1)
        return self.m["head"](params["head"], h)


# ---------------------------------------------------------------------------
# ViT / Swin-lite / Mixer family (Table 4, Fig. 6)
# ---------------------------------------------------------------------------
class ViT(_PaperModel):
    def __init__(self, ctx: ModelContext, *, dim=512, depth=6, heads=8,
                 mlp_dim=512, patch=4, img=32, classes=10):
        self.ctx, self.dim, self.depth, self.heads = ctx, dim, depth, heads
        self.patch, self.img = patch, img
        n_tokens = (img // patch) ** 2
        m = self.m = _Seq()
        m.add("embed", _dense(patch * patch * 3, dim, ctx, name="embed"))
        self.pos = mod.ParamSpec((n_tokens, dim), torch.float32, (None, None),
                                 mod.normal(0.02))
        for i in range(depth):
            m.add(f"l{i}.qkv", _dense(dim, 3 * dim, ctx, name=f"l{i}.qkv"))
            m.add(f"l{i}.proj", _dense(dim, dim, ctx, name=f"l{i}.proj"))
            m.add(f"l{i}.n1", ChannelNorm(dim, ctx))
            m.add(f"l{i}.fc1", _dense(dim, mlp_dim, ctx, name=f"l{i}.fc1"))
            m.add(f"l{i}.fc2", _dense(mlp_dim, dim, ctx, name=f"l{i}.fc2"))
            m.add(f"l{i}.n2", ChannelNorm(dim, ctx))
        m.add("head", _dense(dim, classes, ctx, name="head", kind="head"))

    def specs(self):
        out = self.m.specs()
        out["pos"] = self.pos
        return out

    def __call__(self, params, x):
        m = self.m
        h = m["embed"](params["embed"], _patches(x, self.img, self.patch)) \
            + params["pos"]
        for i in range(self.depth):
            z = m[f"l{i}.n1"](params[f"l{i}.n1"], h)
            o = _attend(m[f"l{i}.qkv"](params[f"l{i}.qkv"], z), self.heads)
            h = h + m[f"l{i}.proj"](params[f"l{i}.proj"], o)
            z = m[f"l{i}.n2"](params[f"l{i}.n2"], h)
            z = gelu(m[f"l{i}.fc1"](params[f"l{i}.fc1"], z))
            h = h + m[f"l{i}.fc2"](params[f"l{i}.fc2"], z)
        return m["head"](params["head"], h.mean(dim=1))


class SwinLite(_PaperModel):
    """Hierarchical transformer (patch-merging stages, full attention
    within a stage): swin-t's parameter profile without windows."""

    def __init__(self, ctx: ModelContext, *, img=32, classes=10,
                 dims=(96, 192, 384, 768), depths=(2, 2, 6, 2), patch=2):
        self.ctx, self.img, self.patch = ctx, img, patch
        self.dims, self.depths = dims, depths
        m = self.m = _Seq()
        m.add("embed", _dense(patch * patch * 3, dims[0], ctx, name="embed"))
        for s, (d, n) in enumerate(zip(dims, depths)):
            for b in range(n):
                pre = f"s{s}b{b}"
                m.add(f"{pre}.qkv", _dense(d, 3 * d, ctx, name=f"{pre}.qkv"))
                m.add(f"{pre}.proj", _dense(d, d, ctx, name=f"{pre}.proj"))
                m.add(f"{pre}.n1", ChannelNorm(d, ctx))
                m.add(f"{pre}.fc1", _dense(d, 4 * d, ctx, name=f"{pre}.fc1"))
                m.add(f"{pre}.fc2", _dense(4 * d, d, ctx, name=f"{pre}.fc2"))
                m.add(f"{pre}.n2", ChannelNorm(d, ctx))
            if s + 1 < len(dims):
                m.add(f"merge{s}", _dense(4 * d, dims[s + 1], ctx,
                                         name=f"merge{s}"))
        m.add("head", _dense(dims[-1], classes, ctx, name="head", kind="head"))

    def __call__(self, params, x):
        m = self.m
        b = x.shape[0]
        h = m["embed"](params["embed"], _patches(x, self.img, self.patch))
        side = self.img // self.patch
        for s, (d, nblk) in enumerate(zip(self.dims, self.depths)):
            heads = max(1, d // 32)
            for blk in range(nblk):
                pre = f"s{s}b{blk}"
                z = m[f"{pre}.n1"](params[f"{pre}.n1"], h)
                o = _attend(m[f"{pre}.qkv"](params[f"{pre}.qkv"], z), heads)
                h = h + m[f"{pre}.proj"](params[f"{pre}.proj"], o)
                z = m[f"{pre}.n2"](params[f"{pre}.n2"], h)
                z = gelu(m[f"{pre}.fc1"](params[f"{pre}.fc1"], z))
                h = h + m[f"{pre}.fc2"](params[f"{pre}.fc2"], z)
            if s + 1 < len(self.dims):
                h = h.reshape(b, side // 2, 2, side // 2, 2, d)
                h = h.permute(0, 1, 3, 2, 4, 5).reshape(b, (side // 2) ** 2, 4 * d)
                h = m[f"merge{s}"](params[f"merge{s}"], h)
                side //= 2
        return m["head"](params["head"], h.mean(dim=1))


class MLPMixer(_PaperModel):
    def __init__(self, ctx: ModelContext, *, dim=512, depth=6, patch=4,
                 img=32, classes=10, token_hidden=256, chan_hidden=256):
        self.ctx, self.dim, self.depth = ctx, dim, depth
        self.patch, self.img = patch, img
        n_tok = self.n_tok = (img // patch) ** 2
        m = self.m = _Seq()
        m.add("embed", _dense(patch * patch * 3, dim, ctx, name="embed"))
        for i in range(depth):
            m.add(f"l{i}.t1", _dense(n_tok, token_hidden, ctx, name=f"l{i}.t1"))
            m.add(f"l{i}.t2", _dense(token_hidden, n_tok, ctx, name=f"l{i}.t2"))
            m.add(f"l{i}.c1", _dense(dim, chan_hidden, ctx, name=f"l{i}.c1"))
            m.add(f"l{i}.c2", _dense(chan_hidden, dim, ctx, name=f"l{i}.c2"))
            m.add(f"l{i}.n1", ChannelNorm(dim, ctx))
            m.add(f"l{i}.n2", ChannelNorm(dim, ctx))
        m.add("head", _dense(dim, classes, ctx, name="head", kind="head"))

    def __call__(self, params, x):
        m = self.m
        h = m["embed"](params["embed"], _patches(x, self.img, self.patch))
        for i in range(self.depth):
            z = m[f"l{i}.n1"](params[f"l{i}.n1"], h).transpose(1, 2)
            z = gelu(m[f"l{i}.t1"](params[f"l{i}.t1"], z))
            h = h + m[f"l{i}.t2"](params[f"l{i}.t2"], z).transpose(1, 2)
            z = m[f"l{i}.n2"](params[f"l{i}.n2"], h)
            z = gelu(m[f"l{i}.c1"](params[f"l{i}.c1"], z))
            h = h + m[f"l{i}.c2"](params[f"l{i}.c2"], z)
        return m["head"](params["head"], h.mean(dim=1))


class ConvMixer(_PaperModel):
    """TRAIN only, as in the reference: the depthwise conv reads the
    master ``w`` of its layer."""

    def __init__(self, ctx: ModelContext, *, dim=256, depth=16, kernel=8,
                 patch=1, img=32, classes=10):
        self.ctx, self.dim, self.depth = ctx, dim, depth
        self.kernel, self.patch, self.img = kernel, patch, img
        m = self.m = _Seq()
        m.add("embed", Conv2D(3, dim, (patch, patch), ctx,
                              stride=(patch, patch), name="embed"))
        for i in range(depth):
            # depthwise: a grouped conv stored as (dim, 1, k, k)
            m.add(f"l{i}.dw", Conv2D(1, dim, (kernel, kernel), ctx,
                                     name=f"l{i}.dw"))
            m.add(f"l{i}.pw", Conv2D(dim, dim, (1, 1), ctx, name=f"l{i}.pw"))
            m.add(f"l{i}.n1", ChannelNorm(dim, ctx))
            m.add(f"l{i}.n2", ChannelNorm(dim, ctx))
        m.add("head", _dense(dim, classes, ctx, name="head", kind="head"))

    def __call__(self, params, x):
        m = self.m
        h = gelu(m["embed"](params["embed"], x))
        k = self.kernel
        for i in range(self.depth):
            w = params[f"l{i}.dw"]["w"]          # (dim, 1, k, k) depthwise
            dw = m[f"l{i}.dw"]
            weff = w
            if dw.spec is not None:
                weff = tiled_weight(w, dw.spec, a=params[f"l{i}.dw"].get("a"),
                                    dtype=h.dtype).reshape(w.shape)
            hp = pad_nhwc(h, (k, k), (1, 1), "SAME")
            z = F.conv2d(hp.permute(0, 3, 1, 2), weff.to(h.dtype),
                         groups=self.dim).permute(0, 2, 3, 1)
            h = h + gelu(m[f"l{i}.n1"](params[f"l{i}.n1"], z))
            z = m[f"l{i}.pw"](params[f"l{i}.pw"], h)
            h = gelu(m[f"l{i}.n2"](params[f"l{i}.n2"], z))
        return m["head"](params["head"], h.mean(dim=(1, 2)))


# ---------------------------------------------------------------------------
# PointNet (Table 3)
# ---------------------------------------------------------------------------
class TNet(_PaperModel):
    """PointNet spatial / feature transform regressor (k x k matrix)."""

    def __init__(self, ctx: ModelContext, k: int, name: str):
        self.ctx, self.k, self.name = ctx, k, name
        m = self.m = _Seq()
        for i, w in enumerate((64, 128, 1024)):
            m.add(f"mlp{i}", _dense(k if i == 0 else (64, 128)[i - 1], w, ctx,
                                   name=f"{name}.mlp{i}"))
            m.add(f"n{i}", ChannelNorm(w, ctx))
        m.add("fc1", _dense(1024, 512, ctx, name=f"{name}.fc1"))
        m.add("fc2", _dense(512, 256, ctx, name=f"{name}.fc2"))
        m.add("out", _dense(256, k * k, ctx, name=f"{name}.out", kind="head"))

    def __call__(self, params, x):
        m = self.m
        h = x
        for i in range(3):
            h = F.relu(m[f"n{i}"](params[f"n{i}"], m[f"mlp{i}"](params[f"mlp{i}"], h)))
        g = h.amax(dim=1)
        g = F.relu(m["fc1"](params["fc1"], g))
        g = F.relu(m["fc2"](params["fc2"], g))
        mat = m["out"](params["out"], g).reshape(-1, self.k, self.k)
        return mat + torch.eye(self.k, device=mat.device)[None]


class PointNet(_PaperModel):
    """Unified PointNet (input / feature T-Nets, shared per-point MLPs,
    global max pool). task: "cls" (k classes), "part" or "sem" (per-point
    logits from global + local features)."""

    def __init__(self, ctx: ModelContext, *, task="cls", classes=40,
                 widths=(64, 64, 64, 128, 1024)):
        self.ctx, self.task, self.classes = ctx, task, classes
        self.widths = widths
        m = self.m = _Seq()
        m.add("tnet1", TNet(ctx, 3, "tnet1"))
        m.add("tnet2", TNet(ctx, widths[1], "tnet2"))
        c_in = 3
        for i, w in enumerate(widths):
            m.add(f"mlp{i}", _dense(c_in, w, ctx, name=f"mlp{i}"))
            m.add(f"n{i}", ChannelNorm(w, ctx))
            c_in = w
        g = widths[-1]
        if task == "cls":
            m.add("fc1", _dense(g, 512, ctx, name="fc1"))
            m.add("fc2", _dense(512, 256, ctx, name="fc2"))
            m.add("head", _dense(256, classes, ctx, name="head", kind="head"))
        else:
            c = g + widths[2]
            self.seg_w = (512, 256, 128) if task == "part" else (256, 128)
            for i, w in enumerate(self.seg_w):
                m.add(f"seg{i}", _dense(c, w, ctx, name=f"seg{i}"))
                m.add(f"sn{i}", ChannelNorm(w, ctx))
                c = w
            m.add("head", _dense(c, classes, ctx, name="head", kind="head"))

    def __call__(self, params, pts):
        """pts (B, N, 3) -> logits: cls (B, k) | seg (B, N, k)."""
        m = self.m
        t1 = m["tnet1"](params["tnet1"], pts)
        h = torch.einsum("bnk,bkj->bnj", pts, t1)
        feats = None
        for i in range(len(self.widths)):
            h = F.relu(m[f"n{i}"](params[f"n{i}"], m[f"mlp{i}"](params[f"mlp{i}"], h)))
            if i == 1:  # feature transform after the 64-wide stage
                h = torch.einsum("bnk,bkj->bnj", h, m["tnet2"](params["tnet2"], h))
            if i == 2:
                feats = h
        g = h.amax(dim=1)                           # (B, g)
        if self.task == "cls":
            z = F.relu(m["fc1"](params["fc1"], g))
            z = F.relu(m["fc2"](params["fc2"], z))
            return m["head"](params["head"], z)
        n = pts.shape[1]
        z = torch.cat([feats, g[:, None, :].expand(g.shape[0], n, g.shape[1])],
                      dim=-1)
        for i in range(len(self.seg_w)):
            z = F.relu(m[f"sn{i}"](params[f"sn{i}"], m[f"seg{i}"](params[f"seg{i}"], z)))
        return m["head"](params["head"], z)


# ---------------------------------------------------------------------------
# Time-series Transformer encoder (Table 5)
# ---------------------------------------------------------------------------
class TSTransformer(_PaperModel):
    def __init__(self, ctx: ModelContext, *, features=321, dim=512, depth=3,
                 heads=8, d_ff=512, horizon=1):
        self.ctx, self.dim, self.depth, self.heads = ctx, dim, depth, heads
        self.features, self.horizon = features, horizon
        m = self.m = _Seq()
        m.add("embed", _dense(features, dim, ctx, name="embed"))
        for i in range(depth):
            m.add(f"l{i}.qkv", _dense(dim, 3 * dim, ctx, name=f"l{i}.qkv"))
            m.add(f"l{i}.proj", _dense(dim, dim, ctx, name=f"l{i}.proj"))
            m.add(f"l{i}.fc1", _dense(dim, d_ff, ctx, name=f"l{i}.fc1"))
            m.add(f"l{i}.fc2", _dense(d_ff, dim, ctx, name=f"l{i}.fc2"))
            m.add(f"l{i}.n1", ChannelNorm(dim, ctx))
            m.add(f"l{i}.n2", ChannelNorm(dim, ctx))
        m.add("head", _dense(dim, features * horizon, ctx, name="head",
                            kind="head"))

    def __call__(self, params, x):
        """x (B, L, F) -> next-step forecast (B, horizon, F)."""
        m = self.m
        b, L, f = x.shape
        h = m["embed"](params["embed"], x)
        pos = torch.arange(L, device=x.device)[None, :, None] / L
        h = h + pos.to(h.dtype)
        for i in range(self.depth):
            z = m[f"l{i}.n1"](params[f"l{i}.n1"], h)
            o = _attend(m[f"l{i}.qkv"](params[f"l{i}.qkv"], z), self.heads)
            h = h + m[f"l{i}.proj"](params[f"l{i}.proj"], o)
            z = m[f"l{i}.n2"](params[f"l{i}.n2"], h)
            z = gelu(m[f"l{i}.fc1"](params[f"l{i}.fc1"], z))
            h = h + m[f"l{i}.fc2"](params[f"l{i}.fc2"], z)
        out = m["head"](params["head"], h[:, -1])
        return out.reshape(b, self.horizon, f)


# ---------------------------------------------------------------------------
# MCU MLP (Table 6 / Algorithm 1)
# ---------------------------------------------------------------------------
class MCUMLP(_PaperModel):
    """784-128-10 MLP."""

    def __init__(self, ctx: ModelContext):
        self.ctx = ctx
        m = self.m = _Seq()
        m.add("fc1", _dense(784, 128, ctx, name="fc1"))
        m.add("head", _dense(128, 10, ctx, name="head", kind="head"))

    def __call__(self, params, x):
        h = F.relu(self.m["fc1"](params["fc1"], x))
        return self.m["head"](params["head"], h)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
def build_paper_model(name: str, ctx: ModelContext, **kw):
    f = {
        "resnet18": lambda: ResNet(18, ctx, **kw),
        "resnet34": lambda: ResNet(34, ctx, **kw),
        "resnet50": lambda: ResNet(50, ctx, **kw),
        "vgg-small": lambda: VGGSmall(ctx, **kw),
        "vit": lambda: ViT(ctx, **kw),
        "swin-lite": lambda: SwinLite(ctx, **kw),
        "mlpmixer": lambda: MLPMixer(ctx, **kw),
        "convmixer": lambda: ConvMixer(ctx, **kw),
        "pointnet": lambda: PointNet(ctx, **kw),
        "ts-transformer": lambda: TSTransformer(ctx, **kw),
        "mcu-mlp": lambda: MCUMLP(ctx),
    }[name]
    return f()
