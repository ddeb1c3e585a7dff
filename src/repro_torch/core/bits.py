"""The layer ledger of ``repro/core/bits.py``: every layer notes its name,
shape, kind and TileSpec here while a model is built. The bit-width report
over it comes with the paper-table slices."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.core.policy import TBNPolicy
from repro_torch.core.tiling import TileSpec


@dataclasses.dataclass
class LayerRecord:
    name: str
    kind: str                      # dense | conv | embedding | norm | head
    shape: Tuple[int, ...]
    spec: Optional[TileSpec]
    binarized: bool
    macs: int = 0


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
