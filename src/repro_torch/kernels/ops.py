"""Tiled layer ops (port of ``repro/kernels/ops.py``: the serving-time
``tiled_dense_infer`` with its three compute paths, the serving-time conv
``tiled_conv_infer``, and the training-time ``tile_construct`` /
``tbn_dense_train``).

``tiled_conv_infer`` pads x spatially (the reference's asymmetric SAME
rule, ``resolve_conv_padding``) and to whole 32-channel words, runs the
conv against the r = c_out/p unique filters of the conv-layout tile
(kernel B6, ``kernels/tiled_conv.py``) and broadcasts the p replicas with
their alphas. The tensor-parallel ``shard_map`` branch of the reference
waits for the mesh work (ROADMAP.md queue A item 9).

``tbn_dense_train`` is the fused training forward: ``tile_construct``
(kernel B5) builds the packed tile and alpha from the masters, then
``tiled_dense_infer`` applies it (B2 at m > 32, B1 below). Its backward
is the gradient of the paper-faithful ``_train_ref_forward``, as in the
reference; the reference has no backward kernel, so neither does the port.

``tiled_dense_infer`` computes y = x @ W_hat^T from the shipped (packed
tile, alpha) form without materializing the dense weight: u = x @ T^T
against the r = n_out/p unique rows, then the p replicas are a
broadcast-scale by alpha. The m-dispatch is the reference's
``_dense_unique_local``: m <= ``MATVEC_MAX_M`` (after flattening lead
dims) goes to kernel B1 (``tiled_matvec_unique``), larger m to kernel B2
(``tiled_matmul_unique``). Under ``compute_path`` "xnor" or "int8" the
m <= ``MATVEC_MAX_M`` batches quantize the activations and accumulate
integers on the packed words instead (kernels B3 / B4,
``kernels/tiled_xnor.py``); larger batches (prefill) keep the float path.
Dispatch between kernel and plain version follows the tensor's device,
inside the wrappers.

Tile layouts: row-packed ``(r, ceil(n_in/32))`` (the shipped serve form)
or flat ``(ceil(q/32),)``. A flat tile is the same bits as the rows only
when 32 | n_in; on the kernel path anything else raises
``FlatTileLayoutError``. On CPU a flat tile takes the reference's
``tiled_matmul_reference`` branch, whatever the compute path (the
reference's ``use_pallas=False`` rule).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core.packing import LANE_BITS, packed_len, unpack_bits
from repro_torch.core.tiling import (
    TileSpec,
    plan_conv_tiling,
    tiled_matmul_reference,
    tiled_weight,
)
from repro_torch.kernels.tile_construct import tile_construct_kernel
from repro_torch.kernels.tiled_conv import tiled_conv_unique
from repro_torch.kernels.tiled_matmul import tiled_matmul_unique
from repro_torch.kernels.tiled_matvec import MATVEC_MAX_M, tiled_matvec_unique
from repro_torch.kernels.tiled_xnor import (
    COMPUTE_PATHS,
    quantize_int8,
    quantize_sign,
    tiled_int8_matvec_unique,
    tiled_xnor_matvec_unique,
)


class FlatTileLayoutError(ValueError):
    """Flat-form packed tile fed to the kernel path with 32 ∤ n_in: row
    boundaries fall mid-word, so the flat bit stream cannot be viewed as
    (r, n_in/32) packed rows."""


def check_compute_path(compute_path: str) -> None:
    if compute_path not in COMPUTE_PATHS:
        raise ValueError(f"unknown compute_path {compute_path!r}: expected "
                         f"one of {COMPUTE_PATHS}")


def _dense_unique_int_local(xm: torch.Tensor, packed_rows: torch.Tensor,
                            compute_path: str) -> torch.Tensor:
    """Integer-domain u = scale * (Q(x) . T^T) (m, r) float32: sign-pack the
    rows for "xnor" (B3), per-row int8 with zero pad columns for "int8"
    (B4); the int32 accumulator is exact, only the scale is a float."""
    n_in = xm.shape[1]
    if compute_path == "xnor":
        xq, scale = quantize_sign(xm, n_in)           # (m, words), (m, 1)
        acc = tiled_xnor_matvec_unique(xq, packed_rows, n_in=n_in)
    else:
        q, scale = quantize_int8(xm, n_in)            # (m, n_in), (m, 1)
        pad = packed_rows.shape[1] * LANE_BITS - n_in
        acc = tiled_int8_matvec_unique(F.pad(q, (0, pad)) if pad else q,
                                       packed_rows)
    return scale * acc.float()


def _dense_unique_local(xm: torch.Tensor, packed_rows: torch.Tensor,
                        compute_path: str = "float") -> torch.Tensor:
    """u = x @ T^T (m, r) float32 against a row-packed tile. m <=
    MATVEC_MAX_M takes the integer path when ``compute_path`` asks for one,
    else B1; larger m takes B2. For the float kernels x is padded with zero
    columns to words*32 (pad bits unpack to -1 but only ever meet those
    zero columns). The kernels take contiguous rows, whatever strides x
    came with (an einsum's output may be transposed)."""
    if compute_path != "float" and xm.shape[0] <= MATVEC_MAX_M:
        return _dense_unique_int_local(xm.contiguous(), packed_rows,
                                       compute_path)
    words = packed_rows.shape[1]
    pad = words * LANE_BITS - xm.shape[1]
    xp = F.pad(xm, (0, pad)) if pad else xm.contiguous()
    if xp.shape[0] <= MATVEC_MAX_M:
        return tiled_matvec_unique(xp, packed_rows)
    return tiled_matmul_unique(xp, packed_rows)


def _replicate_dense_out(u: torch.Tensor, alpha: torch.Tensor, spec: TileSpec
                         ) -> torch.Tensor:
    """u (m, r) -> y (m, p, r): the tile-replica broadcast-scale."""
    m, r = u.shape
    alpha = alpha.to(u.dtype)
    if spec.alpha_mode == "layer":
        return u[:, None, :].expand(m, spec.p, r) * alpha.reshape(1)
    return u[:, None, :] * alpha[None, :, None]


def tiled_dense_infer(x: torch.Tensor, packed: torch.Tensor,
                      alpha: torch.Tensor, spec: TileSpec, *,
                      compute_path: str = "float") -> torch.Tensor:
    """y = x @ W_hat^T from the shipped representation.

    x (..., n_in); packed int32, row-packed (r, ceil(n_in/32)) or flat
    (ceil(q/32),); alpha (n_alpha,). Weight logical shape spec.shape ==
    (n_out, n_in), aligned tiling. ``compute_path`` is "float" (the
    byte-parity reference), "int8" or "xnor"; the integer paths quantize
    the activations of decode-sized batches, so their outputs approximate
    the float path's. Returns (..., n_out) in x's dtype."""
    check_compute_path(compute_path)
    n_out, n_in = spec.shape[0], spec.n // spec.shape[0]
    r = spec.rows_per_tile
    lead = x.shape[:-1]
    xm = x.reshape(-1, n_in)
    if packed.ndim != 2:
        if x.device.type == "cpu":
            t = unpack_bits(packed, spec.q, dtype=x.dtype)
            y = tiled_matmul_reference(xm, t, alpha, spec)
            return y.reshape(*lead, n_out).to(x.dtype)
        if n_in % LANE_BITS:
            raise FlatTileLayoutError(
                f"flat-form packed tile cannot be viewed as packed rows: "
                f"n_in={n_in} is not a multiple of 32 (spec.shape="
                f"{spec.shape}), so row boundaries fall mid-word. Ship the "
                f"row-packed (r, ceil(n_in/32)) serve form for the kernel "
                f"path.")
        packed = packed.reshape(r, n_in // LANE_BITS)
    y3 = _replicate_dense_out(_dense_unique_local(xm, packed, compute_path),
                              alpha, spec)
    return y3.reshape(*lead, n_out).to(x.dtype)


# --------------------------------------------------------------------------
# Inference conv
# --------------------------------------------------------------------------
Padding = Union[str, Sequence[Tuple[int, int]]]


def _conv_spatial(size: int, k: int, s: int, pad) -> Tuple[int, int, int]:
    """(out_size, pad_lo, pad_hi) with ``conv_general_dilated`` semantics:
    SAME puts the odd pad pixel at the high end, SAME_LOWER at the low."""
    if pad in ("SAME", "SAME_LOWER"):
        out = -(-size // s)
        total = max((out - 1) * s + k - size, 0)
        half = total // 2
        lo = half if pad == "SAME" else total - half
        return out, lo, total - lo
    if pad == "VALID":
        lo = hi = 0
    elif isinstance(pad, str):
        raise ValueError(f"unsupported padding {pad!r} for tiled conv")
    else:
        lo, hi = pad
    return (size + lo + hi - k) // s + 1, lo, hi


def resolve_conv_padding(hw: Tuple[int, int], kernel: Tuple[int, int],
                         stride: Tuple[int, int], padding: Padding
                         ) -> Tuple[Tuple[int, int],
                                    Tuple[Tuple[int, int], Tuple[int, int]]]:
    """-> ((OH, OW), explicit ((lo_h, hi_h), (lo_w, hi_w)))."""
    pads = (padding, padding) if isinstance(padding, str) else tuple(padding)
    oh, lo_h, hi_h = _conv_spatial(hw[0], kernel[0], stride[0], pads[0])
    ow, lo_w, hi_w = _conv_spatial(hw[1], kernel[1], stride[1], pads[1])
    return (oh, ow), ((lo_h, hi_h), (lo_w, hi_w))


def pad_nhwc(x: torch.Tensor, kernel: Tuple[int, int], stride: Tuple[int, int],
             padding: Padding, value: float = 0.0) -> torch.Tensor:
    """NHWC x padded explicitly by the reference's rule, for a dense conv or
    a pool that then runs unpadded (PyTorch's own padding is symmetric)."""
    _, ((lo_h, hi_h), (lo_w, hi_w)) = resolve_conv_padding(
        (x.shape[1], x.shape[2]), kernel, stride, padding)
    if not (lo_h or hi_h or lo_w or hi_w):
        return x
    return F.pad(x, (0, 0, lo_w, hi_w, lo_h, hi_h), value=value)


def _replicate_conv_out(u: torch.Tensor, alpha: torch.Tensor, spec: TileSpec
                        ) -> torch.Tensor:
    """u (N, OH, OW, r) -> y (N, OH, OW, p, r), replica-major: output channel
    a*r + j is replica a of unique filter j."""
    n, oh, ow, r = u.shape
    alpha = alpha.to(u.dtype)
    if spec.alpha_mode == "layer":
        return u[..., None, :].expand(n, oh, ow, spec.p, r) * alpha.reshape(1)
    return u[..., None, :] * alpha[:, None]


def tiled_conv_infer(x: torch.Tensor, packed: torch.Tensor,
                     alpha: torch.Tensor, spec: TileSpec, *,
                     stride: Tuple[int, int] = (1, 1),
                     padding: Padding = "SAME") -> torch.Tensor:
    """y = conv(x, W_hat) from the shipped conv representation.

    x (N, H, W, C) NHWC; packed (kh*kw, r, ceil(C/32)) int32 conv-layout
    tile (``core.packing.pack_conv_tile``); alpha (n_alpha,). spec.shape ==
    (c_out, C, kh, kw) with p | c_out. The dense weight never exists: the
    conv runs against the r unique filters (kernel B6 on the card, its
    plain version on the CPU) and the p replicas are a broadcast-scale.
    Returns (N, OH, OW, c_out) in x's dtype."""
    plan = plan_conv_tiling(spec)
    if plan is None:
        raise ValueError(f"spec {spec.shape} has no aligned conv tiling")
    kh, kw = plan.kernel
    sh, sw = stride
    n, h, w, c = x.shape
    if c != plan.c_in:
        raise ValueError(f"x has {c} channels, the tile {plan.c_in}")
    (oh, ow), pads = resolve_conv_padding((h, w), (kh, kw), stride, padding)
    # pad so every kernel read is in bounds, and channels to whole words
    # (zero activations against any tile bit contribute nothing)
    hp = max(h + pads[0][0] + pads[0][1], (oh - 1) * sh + kh)
    wp = max(w + pads[1][0] + pads[1][1], (ow - 1) * sw + kw)
    cpad = packed.shape[2] * LANE_BITS - c
    widths = (0, cpad, pads[1][0], wp - w - pads[1][0], pads[0][0],
              hp - h - pads[0][0])
    xin = F.pad(x, widths) if any(widths) else x.contiguous()
    u = tiled_conv_unique(xin, packed, kernel=(kh, kw), stride=(sh, sw),
                          out_hw=(oh, ow))
    y5 = _replicate_conv_out(u, alpha, spec)
    return y5.reshape(n, oh, ow, spec.p * plan.r).to(x.dtype)


# --------------------------------------------------------------------------
# Construction and the fused training forward
# --------------------------------------------------------------------------
@torch.no_grad()
def tile_construct(w: torch.Tensor, spec: TileSpec,
                   a: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Master weight(s) -> (packed tile int32 (ceil(q/32),), alpha
    (n_alpha,) float32), through kernel B5 on the card. Not differentiable:
    the fused training path takes its gradient from ``_train_ref_forward``.

    As in the reference's Pallas branch: the (p, q) view is padded with
    zero columns to 32 | q (a zero column sum is bit 0, -1; |0| adds
    nothing), the kernel's sum|A| / q_pad is rescaled by q_pad / q, and
    layer-mode alpha is the mean of the per-tile alphas."""
    src = a if spec.alpha_source == "A" else None
    pad = (-spec.q) % LANE_BITS

    def as_2d(v):    # a view of the layer's leaf unless q needs padding
        v2 = v.reshape(spec.p, spec.q)
        return F.pad(v2, (0, pad)) if pad else v2

    w2d = as_2d(w)
    a2d = None if src is None else as_2d(src)
    q_pad = spec.q + pad
    packed, alpha_t = tile_construct_kernel(w2d, a2d)
    alpha_t = alpha_t * (q_pad / spec.q)
    alpha = alpha_t.mean().reshape(1) if spec.alpha_mode == "layer" else alpha_t
    return packed[:packed_len(spec.q)], alpha.float()


def _train_ref_forward(x, w, a, spec: TileSpec) -> torch.Tensor:
    """Paper-faithful reference: materialize B_hat, dense matmul."""
    bhat = tiled_weight(w, spec, a=a, dtype=x.dtype)
    n_out, n_in = spec.shape[0], spec.n // spec.shape[0]
    return x @ bhat.reshape(n_out, n_in).T


class _TbnDenseTrain(torch.autograd.Function):
    """Forward through the kernels (B5, then B2/B1 on the flat tile);
    backward is the exact gradient of ``_train_ref_forward``, which
    recomputes B_hat instead of storing it."""

    @staticmethod
    def forward(ctx, x, w, a, spec):
        packed, alpha = tile_construct(w, spec, a=a)
        ctx.spec = spec
        ctx.save_for_backward(x, w, a)
        return tiled_dense_infer(x, packed, alpha, spec).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w, a = ctx.saved_tensors
        with torch.enable_grad():
            # separate leaves even when a is w: autograd then sums the two
            # gradients into w, as the reference's VJP does
            ins = [v.detach().requires_grad_(need)
                   for v, need in zip((x, w, a), ctx.needs_input_grad[:3])]
            y = _train_ref_forward(*ins, ctx.spec)
            wanted = [v for v in ins if v.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, g, allow_unused=True))
        return (*(next(grads) if v.requires_grad else None for v in ins), None)


def tbn_dense_train(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                    spec: TileSpec) -> torch.Tensor:
    """Training forward of a tiled dense layer via the fused kernels;
    gradient == the reference forward's. ``a`` may be ``w`` (alpha_source
    "W"): pass the same tensor."""
    return _TbnDenseTrain.apply(x, w, a, spec)
