"""TBN application policy — which layers get tiled, and how (port of
``repro/core/policy.py``; the paper's lambda / alpha source / alpha mode)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.core.tiling import (
    AlphaMode,
    AlphaSource,
    SteMode,
    TileSpec,
    plan_tiling,
)

FP32 = "fp32"      # standard full-precision layers
TBN = "tbn"        # tiled binary (sub-bit); "bwnn" is 1 bit per weight


@dataclasses.dataclass(frozen=True)
class TBNPolicy:
    """Model-wide TBN hyperparameters."""

    mode: str = TBN
    p: int = 4
    min_size: int = 64_000
    alpha_mode: AlphaMode = "tile"
    alpha_source: AlphaSource = "A"
    ste: SteMode = "identity"
    require_aligned: bool = True
    skip_embeddings: bool = True
    skip_norms: bool = True
    skip_final_head: bool = False

    def spec_for(self, shape: Sequence[int], *, kind: str = "dense"
                 ) -> Optional[TileSpec]:
        """TileSpec for a weight, or None if the layer stays per-weight.
        kind in {"dense", "conv", "embedding", "norm", "head"}."""
        if self.mode != TBN:
            return None
        if kind == "embedding" and self.skip_embeddings:
            return None
        if kind == "norm" and self.skip_norms:
            return None
        if kind == "head" and self.skip_final_head:
            return None
        return plan_tiling(
            shape, p=self.p, min_size=self.min_size,
            alpha_mode=self.alpha_mode, alpha_source=self.alpha_source,
            ste=self.ste, require_aligned=self.require_aligned,
        )

    def binarize(self, kind: str = "dense") -> bool:
        """Whether a non-tiled layer is binarized (BWNN baseline)."""
        if self.mode == FP32:
            return False
        return kind not in ("embedding", "norm")


def fp32_policy() -> TBNPolicy:
    return TBNPolicy(mode=FP32, p=1)


def tbn_policy(p: int = 4, **kw) -> TBNPolicy:
    return TBNPolicy(mode=TBN, p=p, **kw)
