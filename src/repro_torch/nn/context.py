"""Build-time context shared by all layers of a model instance (port of
``repro/nn/context.py``). There is no ``use_pallas``: kernel-or-plain
dispatch follows the tensor's device."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.bits import LayerLedger
from repro_torch.core.policy import TBNPolicy, fp32_policy
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.ops import check_compute_path

TRAIN = "train"    # params are full-precision masters (W [, A])
SERVE = "serve"    # params are shipped form (packed tile bits + alpha)


@dataclasses.dataclass
class ModelContext:
    """Quantization policy + dtypes + device + accounting for one build.

    ``device`` None means CUDA; without a card that raises unless the
    caller passes ``device="cpu"`` (see ``repro_torch.device``)."""

    policy: TBNPolicy = dataclasses.field(default_factory=fp32_policy)
    mode: str = TRAIN
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    compute_path: str = "float"
    device: DeviceLike = None
    ledger: Optional[LayerLedger] = None

    def __post_init__(self):
        check_compute_path(self.compute_path)
        self.device = resolve_device(self.device)
        if self.ledger is None:
            self.ledger = LayerLedger(self.policy)

    def note(self, name, shape, *, kind, spec, macs=0):
        self.ledger.note(name, shape, kind=kind, spec=spec, macs=macs)
