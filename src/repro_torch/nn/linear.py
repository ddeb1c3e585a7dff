"""Dense and conv layers with first-class TBN quantization (port of
``Dense``, ``Conv2D`` and ``bwnn_weight`` in ``repro/nn/linear.py``).

TRAIN mode holds the full-precision masters and applies the effective
weight: with ``ModelContext(fused_train=True)`` a tiled Dense goes through
``kernels.ops.tbn_dense_train`` (kernel B5, then B2/B1 on the card);
otherwise it materializes B_hat (``tiled_weight_rows``, or ``tiled_weight``
for an unaligned tiling, or ``bwnn_weight`` for a binarized layer below
lambda) and multiplies or convolves densely. Under a mesh
(``distributed.sharding.train_shards``) a rank holds r/TP unique rows of
every replica of a tiled Dense's masters (and, under ``fsdp_weights``, a
block of n_in, gathered at use) and runs the per-shard branch of
``kernels.ops`` (``tbn_dense_train_rows`` / ``dense_train_rows``). SERVE mode
carries the shipped form: a tiled layer applies through the tile-reuse math
(``kernels.ops.tiled_dense_infer``: kernels B1/B2 on the card;
``kernels.ops.tiled_conv_infer``: kernel B6); an unaligned tile and the
BWNN sign bits (``wbits``) are unpacked to the dense weight, as in the
reference.

Conv layouts are the reference's: NHWC activations, OIHW weights. The
dense conv (``Conv2D._dense_conv``) pads explicitly by the reference's
asymmetric SAME rule and runs ``F.conv2d`` on NCHW views; a tiled conv
never goes through it in SERVE mode.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.packing import packed_len, unpack_bits
from repro_torch.core.tiling import (
    TileSpec,
    _ste_sign,
    plan_conv_tiling,
    reconstruct_from_tile,
    tiled_weight,
    tiled_weight_rows,
)
from repro_torch.distributed.sharding import (
    _mesh_extent,
    dense_train_shards,
    fsdp_gather,
    slots_matmul,
)
from repro_torch.kernels.ops import (
    Padding,
    dense_train_rows,
    pad_nhwc,
    tbn_dense_train,
    tbn_dense_train_rows,
    tiled_conv_infer,
    tiled_dense_infer,
)
from repro_torch.nn import module as mod
from repro_torch.nn.context import SERVE, ModelContext


def bwnn_weight(w: torch.Tensor, compute_dtype) -> torch.Tensor:
    """XNOR-Net style binary weight: sign(W) * mean|W| with identity STE."""
    return (_ste_sign(w) * w.abs().mean()).to(compute_dtype)


@dataclasses.dataclass
class Dense:
    """y = x @ W^T (+b). Weight stored (n_out, n_in) — paper layout, so the
    row-major tile replication lands on output rows."""

    n_in: int
    n_out: int
    ctx: ModelContext
    name: str = "dense"
    kind: str = "dense"            # "dense" | "head"
    use_bias: bool = False
    logical: Tuple[Optional[str], Optional[str]] = ("mlp", "embed")  # (out, in)

    def __post_init__(self):
        self.spec: Optional[TileSpec] = self.ctx.policy.spec_for(
            (self.n_out, self.n_in), kind=self.kind)
        self.ctx.note(self.name, (self.n_out, self.n_in), kind=self.kind,
                      spec=self.spec)

    def specs(self) -> mod.SpecTree:
        if self.ctx.mode == SERVE:
            return self._serve_specs()
        pd = self.ctx.param_dtype
        shape = (self.n_out, self.n_in)
        # row-aligned masters name their p replicas: under a mesh a rank
        # holds r/TP of the r unique rows of every replica
        tp = self.spec.p if self.spec is not None and self.spec.aligned_rows else 0
        out: dict = {"w": mod.ParamSpec(shape, pd, self.logical, mod.kaiming(), tp)}
        if self.spec is not None and self.spec.alpha_source == "A":
            out["a"] = mod.ParamSpec(shape, pd, self.logical, mod.kaiming(), tp)
        if self.use_bias:
            out["b"] = mod.ParamSpec((self.n_out,), pd, (self.logical[0],),
                                     mod.zeros_init())
        return out

    def _serve_specs(self) -> mod.SpecTree:
        out: dict = {}
        if self.spec is not None and self.spec.aligned_rows:
            # shipped form: one word-padded packed row per unique weight
            # row; the row axis is the tensor-parallel shard axis (each
            # rank of a mesh's model axis holds r/TP rows)
            out["tile"] = mod.ParamSpec(
                (self.spec.rows_per_tile, packed_len(self.n_in)), torch.int32,
                ("tile_rows", None), mod.zeros_init())
            out["alpha"] = mod.ParamSpec((self.spec.n_alpha,), torch.float32,
                                         (None,), mod.ones_init())
        elif self.spec is not None:
            # unaligned tiling: flat q-bit tile, dense reconstruction
            out["tile"] = mod.ParamSpec((packed_len(self.spec.q),), torch.int32,
                                        (None,), mod.zeros_init())
            out["alpha"] = mod.ParamSpec((self.spec.n_alpha,), torch.float32,
                                         (None,), mod.ones_init())
        elif self.ctx.policy.binarize(self.kind):
            # BWNN: one packed sign row per weight row + one layer alpha
            out["wbits"] = mod.ParamSpec((self.n_out, packed_len(self.n_in)),
                                         torch.int32, (self.logical[0], None),
                                         mod.zeros_init())
            out["alpha"] = mod.ParamSpec((1,), torch.float32, (None,),
                                         mod.ones_init())
        else:
            out["w"] = mod.ParamSpec((self.n_out, self.n_in),
                                     self.ctx.compute_dtype, self.logical,
                                     mod.kaiming())
        if self.use_bias:
            out["b"] = mod.ParamSpec((self.n_out,), torch.float32,
                                     (self.logical[0],), mod.zeros_init())
        return out

    def __call__(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        if self.ctx.mode == SERVE:
            y = self._serve_apply(params, x)
        else:
            y = self._train_apply(params, x)
        if self.use_bias:
            y = y + params["b"].to(y.dtype)
        return y

    def _train_apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        cd = self.ctx.compute_dtype
        shards = (dense_train_shards(self.spec.rows_per_tile, self.n_in,
                                     self.ctx.fsdp_weights)
                  if self.spec is not None and self.spec.aligned_rows else None)
        if shards is not None:
            params, rows = self._gather_masters(params, shards)
            if rows:
                mesh = shards[0]
                w, a = params["w"], params.get("a")
                if self.ctx.fused_train:
                    return tbn_dense_train_rows(x.to(cd), w, w if a is None else a,
                                                self.spec, mesh, rows)
                return dense_train_rows(x.to(cd), w, a, self.spec, mesh, rows)
        w = params["w"]
        if self.spec is not None and self.ctx.fused_train:
            return tbn_dense_train(x.to(cd), w, params.get("a", w), self.spec)
        if self.spec is not None and self.spec.aligned_rows:
            weff = tiled_weight_rows(w, self.spec, a=params.get("a"), dtype=cd)
        elif self.spec is not None:
            weff = tiled_weight(w, self.spec, a=params.get("a"), dtype=cd
                                ).reshape(self.n_out, self.n_in)
        elif self.ctx.policy.binarize(self.kind):
            weff = bwnn_weight(w, cd)
        else:
            weff = w.to(cd)
        return x.to(cd) @ weff.T

    def _gather_masters(self, params: dict, shards):
        """A rank's masters under a mesh (``distributed.sharding.
        train_shards``): under ``fsdp_weights`` their n_in blocks gathered
        over "data" (the gradient is reduce-scattered back). Returns the
        params and the axes that split the r unique rows, whose per-shard
        branch of ``kernels.ops`` then runs (fused: B5 + B2 on the rank's
        rows)."""
        mesh, rows, cols = shards
        want = (self.spec.p * self.spec.rows_per_tile // _mesh_extent(mesh, rows),
                self.n_in // _mesh_extent(mesh, cols))
        if tuple(params["w"].shape) != want:
            raise ValueError(f"{self.name}: the rank holds masters "
                             f"{tuple(params['w'].shape)}; under this mesh it "
                             f"holds {want} (place the params with "
                             f"distributed.sharding.place_train_params)")
        out = dict(params, w=fsdp_gather(params["w"], mesh, cols))
        if "a" in params:
            out["a"] = fsdp_gather(params["a"], mesh, cols)
        return out, rows

    def _serve_apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        cd = self.ctx.compute_dtype
        x = x.to(cd)
        if self.spec is not None and self.spec.aligned_rows:
            return tiled_dense_infer(x, params["tile"], params["alpha"],
                                     self.spec,
                                     compute_path=self.ctx.compute_path)
        if self.spec is not None:  # unaligned: documented dense fallback
            t = unpack_bits(params["tile"], self.spec.q, dtype=cd)
            w = reconstruct_from_tile(t, params["alpha"], self.spec, dtype=cd)
            return slots_matmul(x, w.reshape(self.n_out, self.n_in).T)
        if "wbits" in params:
            w = unpack_bits(params["wbits"], self.n_in, dtype=cd)
            return slots_matmul(x, (w * params["alpha"].to(cd)).T)
        return slots_matmul(x, params["w"].to(cd).T)


@dataclasses.dataclass
class Conv2D:
    """NHWC conv with an OIHW-stored weight (paper layout: tiles replicate
    whole output-channel filters).

    SERVE forms: ``tile_conv`` (aligned tiling, conv-layout packed tile +
    alpha, through ``tiled_conv_infer``), flat ``tile`` (unaligned tiling,
    only reachable with ``require_aligned=False``: dense reconstruction),
    ``wbits`` (BWNN below lambda: dense reconstruction) and ``w``."""

    c_in: int
    c_out: int
    kernel: Tuple[int, int]
    ctx: ModelContext
    stride: Tuple[int, int] = (1, 1)
    padding: Padding = "SAME"
    name: str = "conv"
    use_bias: bool = False

    def __post_init__(self):
        kh, kw = self.kernel
        self.wshape = (self.c_out, self.c_in, kh, kw)
        self.spec: Optional[TileSpec] = self.ctx.policy.spec_for(
            self.wshape, kind="conv")
        self.plan = plan_conv_tiling(self.spec)
        self.ctx.note(self.name, self.wshape, kind="conv", spec=self.spec)

    def specs(self) -> mod.SpecTree:
        if self.ctx.mode == SERVE:
            return self._serve_specs()
        pd = self.ctx.param_dtype
        out: dict = {"w": mod.ParamSpec(self.wshape, pd, (None,) * 4,
                                        mod.kaiming())}
        if self.spec is not None and self.spec.alpha_source == "A":
            out["a"] = mod.ParamSpec(self.wshape, pd, (None,) * 4, mod.kaiming())
        if self.use_bias:
            out["b"] = mod.ParamSpec((self.c_out,), torch.float32, (None,),
                                     mod.zeros_init())
        return out

    def _serve_specs(self) -> mod.SpecTree:
        out: dict = {}
        if self.plan is not None:
            # (kh*kw, r, words): the unique-filter axis is the tensor-parallel
            # shard axis, as the dense row tile's
            out["tile_conv"] = mod.ParamSpec(self.plan.packed_shape(),
                                             torch.int32,
                                             (None, "tile_rows", None),
                                             mod.zeros_init())
            out["alpha"] = mod.ParamSpec((self.spec.n_alpha,), torch.float32,
                                         (None,), mod.ones_init())
        elif self.spec is not None:  # unaligned: flat tile, dense fallback
            out["tile"] = mod.ParamSpec((packed_len(self.spec.q),), torch.int32,
                                        (None,), mod.zeros_init())
            out["alpha"] = mod.ParamSpec((self.spec.n_alpha,), torch.float32,
                                         (None,), mod.ones_init())
        elif self.ctx.policy.binarize("conv"):
            kh, kw = self.kernel
            out["wbits"] = mod.ParamSpec(
                (self.c_out, packed_len(self.c_in * kh * kw)), torch.int32,
                (None, None), mod.zeros_init())
            out["alpha"] = mod.ParamSpec((1,), torch.float32, (None,),
                                         mod.ones_init())
        else:
            out["w"] = mod.ParamSpec(self.wshape, self.ctx.compute_dtype,
                                     (None,) * 4, mod.kaiming())
        if self.use_bias:
            out["b"] = mod.ParamSpec((self.c_out,), torch.float32, (None,),
                                     mod.zeros_init())
        return out

    def __call__(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        cd = self.ctx.compute_dtype
        if self.ctx.mode == SERVE:
            y = self._serve_apply(params, x.to(cd))
        else:
            w = params["w"]
            if self.spec is not None:
                w = tiled_weight(w, self.spec, a=params.get("a"), dtype=cd
                                 ).reshape(self.wshape)
            elif self.ctx.policy.binarize("conv"):
                w = bwnn_weight(w, cd)
            else:
                w = w.to(cd)
            y = self._dense_conv(x.to(cd), w)
        if self.use_bias:
            y = y + params["b"].to(y.dtype)
        return y

    def _dense_conv(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """NHWC x (*) OIHW w with the reference's padding, by ``F.conv2d``."""
        x = pad_nhwc(x, self.kernel, self.stride, self.padding)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=tuple(self.stride))
        return y.permute(0, 2, 3, 1)

    def _serve_apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        cd = self.ctx.compute_dtype
        if "tile_conv" in params:
            return tiled_conv_infer(x, params["tile_conv"], params["alpha"],
                                    self.spec, stride=self.stride,
                                    padding=self.padding)
        if "tile" in params:  # unaligned tiling: documented dense fallback
            t = unpack_bits(params["tile"], self.spec.q, dtype=cd)
            w = reconstruct_from_tile(t, params["alpha"], self.spec, dtype=cd)
            return self._dense_conv(x, w)
        if "wbits" in params:
            kh, kw = self.kernel
            w = unpack_bits(params["wbits"], self.c_in * kh * kw, dtype=cd)
            w = (w * params["alpha"].to(cd)).reshape(self.wshape)
            return self._dense_conv(x, w)
        return self._dense_conv(x, params["w"].to(cd))
