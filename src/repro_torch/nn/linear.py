"""Dense layer with first-class TBN quantization (port of ``Dense`` and
``bwnn_weight`` in ``repro/nn/linear.py``).

TRAIN mode holds the full-precision masters and applies the effective
weight: with ``ModelContext(fused_train=True)`` a tiled layer goes through
``kernels.ops.tbn_dense_train`` (kernel B5, then B2/B1 on the card);
otherwise it materializes B_hat (``tiled_weight_rows``, or ``tiled_weight``
for an unaligned tiling) and multiplies densely. SERVE mode carries the
shipped form and applies it through the tile-reuse math
(``kernels.ops.tiled_dense_infer``: kernels B1/B2 on the card).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.packing import packed_len, unpack_bits
from repro_torch.core.tiling import (
    TileSpec,
    _ste_sign,
    reconstruct_from_tile,
    tiled_weight,
    tiled_weight_rows,
)
from repro_torch.kernels.ops import tbn_dense_train, tiled_dense_infer
from repro_torch.nn import module as mod
from repro_torch.nn.context import SERVE, ModelContext

BWNN_ITEM = "ROADMAP.md queue A item 9 (conv and the paper's BWNN baselines)"


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
        out: dict = {"w": mod.ParamSpec(shape, pd, mod.kaiming())}
        if self.spec is not None and self.spec.alpha_source == "A":
            out["a"] = mod.ParamSpec(shape, pd, mod.kaiming())
        if self.use_bias:
            out["b"] = mod.ParamSpec((self.n_out,), pd, mod.zeros_init())
        return out

    def _serve_specs(self) -> mod.SpecTree:
        out: dict = {}
        if self.spec is not None and self.spec.aligned_rows:
            # shipped form: one word-padded packed row per unique weight row
            out["tile"] = mod.ParamSpec(
                (self.spec.rows_per_tile, packed_len(self.n_in)), torch.int32,
                mod.zeros_init())
            out["alpha"] = mod.ParamSpec((self.spec.n_alpha,), torch.float32,
                                         mod.ones_init())
        elif self.spec is not None:
            # unaligned tiling: flat q-bit tile, dense reconstruction
            out["tile"] = mod.ParamSpec((packed_len(self.spec.q),), torch.int32,
                                        mod.zeros_init())
            out["alpha"] = mod.ParamSpec((self.spec.n_alpha,), torch.float32,
                                         mod.ones_init())
        elif self.ctx.policy.binarize(self.kind):
            raise NotImplementedError(
                f"{self.name}: the BWNN serve form is not ported yet: {BWNN_ITEM}")
        else:
            out["w"] = mod.ParamSpec((self.n_out, self.n_in),
                                     self.ctx.compute_dtype, mod.kaiming())
        if self.use_bias:
            out["b"] = mod.ParamSpec((self.n_out,), torch.float32, mod.zeros_init())
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
        cd, w = self.ctx.compute_dtype, params["w"]
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
            return x @ w.reshape(self.n_out, self.n_in).T
        return x @ params["w"].to(cd).T
