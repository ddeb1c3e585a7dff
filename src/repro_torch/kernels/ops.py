"""Tiled layer ops (port of ``repro/kernels/ops.py``: the serving-time
``tiled_dense_infer`` with its three compute paths, the serving-time conv
``tiled_conv_infer``, and the training-time ``tile_construct`` /
``tbn_dense_train``).

``tiled_conv_infer`` pads x spatially (the reference's asymmetric SAME
rule, ``resolve_conv_padding``) and to whole 32-channel words, runs the
conv against the r = c_out/p unique filters of the conv-layout tile
(kernel B6, ``kernels/tiled_conv.py``) and broadcasts the p replicas with
their alphas.

Under an active mesh (``distributed.sharding.axis_rules``) both serve ops
are tensor-parallel, as the reference's ``shard_map`` branches are: the
tile's unique rows (filters) are split over the "tile_rows" axis, each rank
runs the same kernel on its r/TP rows (and its block of the batch over
"data" where that axis divides it) and all_gathers its block of unique
rows (over "model" along the rows, then over "data" along the batch);
every rank then replicates the whole rows with the whole alpha, so a
gather carries 1/p of the layer's output. Flat tiles never engage it.
Inside a model's serving entry point whose slots split over "data"
(``sharding.slot_rows``) x is already the rank's rows: the dense op then
splits and gathers no rows (the tile rows alone are gathered over
"model"), which saves a tiled layer its data-axis gather. A rank
dispatches on the whole batch's m and its float kernels plan for the
whole (m, r), their plain versions placing the rank's block at its
offset, so it runs the kernel, the compute path and the summation order
that one card would: its block equals that card's rows bit for bit. B6
likewise plans for the whole call's pixels and filters.

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

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core.packing import LANE_BITS, packed_len, unpack_bits
from repro_torch.core.tiling import (
    TileSpec,
    _ConstructRowsIdentity,
    plan_conv_tiling,
    tiled_matmul_reference,
    tiled_weight,
)
from repro_torch.distributed.sharding import (
    _mesh_extent,
    active_slots,
    batch_shard_axes,
    copy_to_shards,
    gather_blocks,
    gather_shards,
    local_block,
    shard_index,
    sum_over,
    sum_shards,
    tile_sharding,
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
                        compute_path: str = "float",
                        whole: Optional[Tuple[int, int, int, int]] = None
                        ) -> torch.Tensor:
    """u = x @ T^T (m, r) float32 against a row-packed tile. m <=
    MATVEC_MAX_M takes the integer path when ``compute_path`` asks for one,
    else B1; larger m takes B2. ``whole`` (M, R, row0, col0) is the call a
    rank holds the block at (row0, col0) of: the dispatch reads its M, the
    float kernels plan for (M, R) and their plain versions place the block
    at its offset, so the rank's elements equal one card's bit for bit
    (the integer paths are exact whatever the block). For the float
    kernels x is padded with zero columns to words*32 (pad bits unpack to
    -1 but only ever meet those zero columns). The kernels take contiguous
    rows, whatever strides x came with (an einsum's output may be
    transposed)."""
    m = xm.shape[0] if whole is None else whole[0]
    if compute_path != "float" and m <= MATVEC_MAX_M:
        return _dense_unique_int_local(xm.contiguous(), packed_rows,
                                       compute_path)
    words = packed_rows.shape[1]
    pad = words * LANE_BITS - xm.shape[1]
    xp = F.pad(xm, (0, pad)) if pad else xm.contiguous()
    if m <= MATVEC_MAX_M:
        return tiled_matvec_unique(xp, packed_rows, whole)
    return tiled_matmul_unique(xp, packed_rows, whole)


def _check_shard_rows(packed_rows: int, r: int, extent: int, what: str) -> None:
    if packed_rows * extent != r:
        raise ValueError(f"{what} holds {packed_rows} unique rows; under a "
                         f"model axis of {extent} a rank holds r / TP = "
                         f"{r // extent} of r = {r} (place the params with "
                         f"distributed.sharding.place_params)")


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
    tp = tile_sharding(r) if packed.ndim == 2 else None
    slots = active_slots() if packed.ndim == 2 else None
    if tp is not None or slots is not None:
        m = xm.shape[0]
        ax, col0 = (), 0
        if tp is not None:
            mesh, ax, extent = tp
            _check_shard_rows(packed.shape[0], r, extent, "the tile")
            col0 = shard_index(mesh, ax) * packed.shape[0]
        if slots is not None:
            # x is already the rank's slots' rows: plan for every slot's
            m_ax, xl = (), xm
            whole = (m * slots.extent, r, slots.index * m, col0)
        else:
            m_ax = batch_shard_axes(ax, m)
            xl = local_block(xm, mesh, m_ax, 0)
            whole = (m, r, shard_index(mesh, m_ax) * xl.shape[0], col0)
        u = _dense_unique_local(xl, packed, compute_path, whole=whole)
        if tp is not None:
            u = gather_blocks(gather_blocks(u, mesh, ax, 1), mesh, m_ax, 0)
    else:
        if packed.ndim != 2:
            if x.device.type == "cpu":
                t = unpack_bits(packed, spec.q, dtype=x.dtype)
                y = tiled_matmul_reference(xm, t, alpha, spec)
                return y.reshape(*lead, n_out).to(x.dtype)
            if n_in % LANE_BITS:
                raise FlatTileLayoutError(
                    f"flat-form packed tile cannot be viewed as packed rows: "
                    f"n_in={n_in} is not a multiple of 32 (spec.shape="
                    f"{spec.shape}), so row boundaries fall mid-word. Ship "
                    f"the row-packed (r, ceil(n_in/32)) serve form for the "
                    f"kernel path.")
            packed = packed.reshape(r, n_in // LANE_BITS)
        u = _dense_unique_local(xm, packed, compute_path)
    y3 = _replicate_dense_out(u, alpha, spec)
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
    tp = tile_sharding(plan.r)
    if tp is None:
        u = tiled_conv_unique(xin, packed, kernel=(kh, kw), stride=(sh, sw),
                              out_hw=(oh, ow))
    else:
        mesh, ax, extent = tp
        _check_shard_rows(packed.shape[1], plan.r, extent, "the conv tile")
        n_ax = batch_shard_axes(ax, n)
        u = tiled_conv_unique(local_block(xin, mesh, n_ax, 0).contiguous(),
                              packed, kernel=(kh, kw), stride=(sh, sw),
                              out_hw=(oh, ow), plan_shape=(n * oh * ow, plan.r))
        u = gather_blocks(gather_blocks(u, mesh, ax, 3), mesh, n_ax, 0)
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


# --------------------------------------------------------------------------
# The training forward under a model axis: a rank holds r/TP unique rows of
# every replica of the masters
# --------------------------------------------------------------------------
def _rows_spec(spec: TileSpec, w: torch.Tensor) -> TileSpec:
    """The tiling of a rank's (p * r/TP, n_in) block of the masters."""
    rows, n_in = w.shape[-2:]
    if rows % spec.p or n_in % LANE_BITS:
        raise ValueError(f"a rank's masters {tuple(w.shape)} must be p = "
                         f"{spec.p} replicas of whole rows of whole 32-bit "
                         f"words (spec {spec.shape})")
    return dataclasses.replace(spec, shape=(rows, n_in), q=rows // spec.p * n_in)


def _tp_train_rows(x, w, a, spec: TileSpec, mesh, rows) -> torch.Tensor:
    """The effective-weight form of a rank's rows: y (..., p, r/TP) =
    x @ B_hat_rank^T, B_hat_rank = alpha * sign(column sums of the rank's
    (p, r/TP, n_in) block) with the identity STE of ``tiled_weight_rows``,
    and alpha the whole layer's (the rank's per-tile means of |A| summed
    over ``rows`` and divided by TP). Its autograd graph carries the
    gradient a rank needs: dx summed over ``rows`` (each rank's rows give a
    part), d alpha summed over ``rows`` (each rank's outputs scale by it),
    and the master rows' STE gradient, local to their columns."""
    p, (n_rows, d) = spec.p, w.shape[-2:]
    r_loc, tp = n_rows // p, _mesh_extent(mesh, rows)
    b = _ConstructRowsIdentity.apply(w, p).reshape(p, r_loc, d)
    src = a if spec.alpha_source == "A" else w
    if spec.alpha_mode == "layer":
        alpha = sum_shards(src.abs().mean().reshape(1), mesh, rows) / tp
    else:
        alpha = sum_shards(src.reshape(p, r_loc, d).abs().mean(dim=(-1, -2)),
                           mesh, rows) / tp
    bhat = (b * alpha.reshape(-1, 1, 1)).to(x.dtype).reshape(n_rows, d)
    y = copy_to_shards(x, mesh, rows) @ bhat.T
    return y.unflatten(-1, (p, r_loc))


def dense_train_rows(x, w, a, spec: TileSpec, mesh, rows) -> torch.Tensor:
    """The unfused training forward of a rank holding r/TP rows of every
    replica: its rows of the effective weight, then its block of the
    output gathered over ``rows`` (the gradient's own block goes back).
    Returns the whole (..., n_out) on every rank."""
    _rows_spec(spec, w)
    y = gather_shards(_tp_train_rows(x, w, a, spec, mesh, rows), mesh, rows, -1)
    return y.flatten(-2)


class _TbnDenseTrainRows(torch.autograd.Function):
    """Fused forward of a rank's rows: B5 on the rank's (p, r/TP * n_in)
    slab (its words are one card's rows of the tile), alpha's per-tile
    partials summed over ``rows``, B2 (B1 at m <= 32) on the rank's rows
    planned for the whole (m, r), the unique rows gathered over ``rows``
    and replicated with the whole alpha. Backward: the gradient of
    ``_tp_train_rows`` against the rank's block of the output gradient,
    which recomputes B_hat's rows instead of storing them."""

    @staticmethod
    def forward(ctx, x, w, a, spec, mesh, rows):
        local = _rows_spec(spec, w)
        packed, alpha = tile_construct(w, local, a=a)
        alpha = sum_over(alpha, mesh, rows) / _mesh_extent(mesh, rows)
        n_in, r = local.shape[1], spec.rows_per_tile
        xm = x.reshape(-1, n_in)
        rows_local = packed.reshape(-1, n_in // LANE_BITS)
        u = _dense_unique_local(xm, rows_local, whole=(
            xm.shape[0], r, 0, shard_index(mesh, rows) * rows_local.shape[0]))
        u = gather_blocks(u, mesh, rows, 1)
        ctx.spec, ctx.mesh, ctx.rows = spec, mesh, rows
        ctx.save_for_backward(x, w, a)
        y = _replicate_dense_out(u, alpha, spec)
        return y.reshape(*x.shape[:-1], spec.shape[0]).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w, a = ctx.saved_tensors
        spec, mesh, rows = ctx.spec, ctx.mesh, ctx.rows
        g_rows = local_block(g.unflatten(-1, (spec.p, spec.rows_per_tile)),
                             mesh, rows, -1)
        with torch.enable_grad():
            ins = [v.detach().requires_grad_(need)
                   for v, need in zip((x, w, a), ctx.needs_input_grad[:3])]
            y = _tp_train_rows(*ins, spec, mesh, rows)
            wanted = [v for v in ins if v.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, g_rows, allow_unused=True))
        return (*(next(grads) if v.requires_grad else None for v in ins),
                None, None, None)


def tbn_dense_train_rows(x, w, a, spec: TileSpec, mesh, rows) -> torch.Tensor:
    """``tbn_dense_train`` for a rank holding r/TP rows of every replica of
    the masters (``distributed.sharding.train_shards``); ``a`` may be
    ``w``. Returns the whole (..., n_out) on every rank."""
    return _TbnDenseTrainRows.apply(x, w, a, spec, mesh, rows)
