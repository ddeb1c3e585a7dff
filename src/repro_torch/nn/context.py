"""Build-time context shared by all layers of a model instance (port of
``repro/nn/context.py``). There is no ``use_pallas``: kernel-or-plain
dispatch follows the tensor's device."""
from __future__ import annotations

import contextlib
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
    fused_train: bool = False      # TRAIN: tiled Dense through kernel B5
    fsdp_weights: bool = False     # TRAIN under a mesh: gather n_in at use
    device: DeviceLike = None
    ledger: Optional[LayerLedger] = None

    def __post_init__(self):
        check_compute_path(self.compute_path)
        self.device = resolve_device(self.device)
        if self.ledger is None:
            self.ledger = LayerLedger(self.policy)

    def note(self, name, shape, *, kind, spec, macs=0):
        self.ledger.note(name, shape, kind=kind, spec=spec, macs=macs)


@contextlib.contextmanager
def full_f32_matmul():
    """f32 products in full f32: TF32 off for the duration (the reference's
    f32 dots run at full precision)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
