"""The port's device rule: CUDA unless the caller explicitly asks for CPU.

There is no silent CPU fallback. An entry point called without a device
on a host with no usable CUDA card raises, so a run that was meant for the
card can never quietly measure PyTorch's CPU kernels instead.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


class NoCudaDeviceError(RuntimeError):
    """A CUDA device was required (explicitly or by default) but none is
    available."""


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; an explicit device is taken as given.

    Raises :class:`NoCudaDeviceError` when the result is a CUDA device and
    ``torch.cuda.is_available()`` is false."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCudaDeviceError(
            "no CUDA device is available; repro_torch runs on the GPU by "
            "default. Pass device='cpu' (CLI: --device cpu) to run the "
            "plain PyTorch versions of the kernels on the host instead."
        )
    return dev

