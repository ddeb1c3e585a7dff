"""Bit-width / parameter / bit-ops accounting of the paper's tables (port
of ``repro/core/bits.py``).

Every layer notes its name, shape, kind and TileSpec in a ``LayerLedger``
while a model is built; ``report()`` turns that into a ``BitsReport``.
The universe is the binarizable weights only (conv, dense and head; biases,
norms and embeddings are excluded). A tiled layer stores q bits plus 32 per
alpha; an untiled binarized layer 1 bit per weight plus one 32-bit alpha;
a full-precision layer 32 bits per weight. One MAC against a binary weight
is one bit-op, and an aligned tiled layer runs 1/p of its MACs.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.policy import TBNPolicy
from repro_torch.core.tiling import TileSpec

_UNIVERSE = ("dense", "conv", "head")


@dataclasses.dataclass
class LayerRecord:
    name: str
    kind: str                      # dense | conv | embedding | norm | head
    shape: Tuple[int, ...]
    spec: Optional[TileSpec]       # None: not tiled
    binarized: bool                # BWNN when not tiled
    macs: int = 0                  # multiply-accumulates per forward pass

    @property
    def n(self) -> int:
        return int(np.prod(self.shape))

    def stored_bits(self) -> int:
        if self.spec is not None:
            return self.spec.stored_bits
        if self.binarized:
            return self.n + 32     # + one XNOR-style layer alpha
        return 32 * self.n

    def bitops(self) -> float:
        if self.spec is not None and self.spec.aligned_rows:
            return self.macs / self.spec.p
        return float(self.macs)


@dataclasses.dataclass
class BitsReport:
    layers: List[LayerRecord]

    def _universe(self) -> List[LayerRecord]:
        return [r for r in self.layers if r.kind in _UNIVERSE]

    @property
    def universe_params(self) -> int:
        """Binarizable parameter count (the paper's #Params denominator)."""
        return sum(r.n for r in self._universe())

    def total_bits(self) -> int:
        return sum(r.stored_bits() for r in self._universe())

    def mbit(self) -> float:
        return self.total_bits() / 1e6

    def bits_per_param(self) -> float:
        u = self.universe_params
        return self.total_bits() / u if u else 0.0

    def savings_vs_binary(self) -> float:
        """The paper's 'savings' factor: 1-bit model bits / these bits."""
        bits = self.total_bits()
        return self.universe_params / bits if bits else 0.0

    def total_bitops(self) -> float:
        return sum(r.bitops() for r in self._universe())

    def rows(self) -> List[dict]:
        return [dict(name=r.name, kind=r.kind, shape=list(r.shape), params=r.n,
                     tiled=r.spec is not None,
                     p=(r.spec.p if r.spec else 1),
                     q=(r.spec.q if r.spec else None),
                     stored_bits=r.stored_bits(), macs=r.macs,
                     bitops=r.bitops())
                for r in self.layers]

    def summary(self, name: str = "") -> dict:
        return dict(model=name, universe_params=self.universe_params,
                    mbit=round(self.mbit(), 3),
                    bits_per_param=round(self.bits_per_param(), 4),
                    savings_vs_binary=round(self.savings_vs_binary(), 2),
                    gbitops=round(self.total_bitops() / 1e9, 4))


class LayerLedger:
    """Collected while a model instantiates its layers under a TBNPolicy."""

    def __init__(self, policy: TBNPolicy):
        self.policy = policy
        self.records: List[LayerRecord] = []

    def note(self, name: str, shape: Tuple[int, ...], *, kind: str = "dense",
             spec: Optional[TileSpec] = None, macs: int = 0) -> None:
        self.records.append(LayerRecord(
            name=name, kind=kind, shape=tuple(int(d) for d in shape),
            spec=spec, binarized=self.policy.binarize(kind) and spec is None,
            macs=int(macs),
        ))

    def report(self) -> BitsReport:
        return BitsReport(list(self.records))
