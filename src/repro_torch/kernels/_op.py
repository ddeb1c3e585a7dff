"""The kernels as dispatcher operators (``torch.library.custom_op``).

Each of B1-B6 is registered as ``repro_torch::<name>``: its CUDA
implementation launches the kernel, its CPU implementation runs the plain
PyTorch version, and its fake implementation gives the output's shape and
dtype without running anything (the ``meta`` device of the dry run,
``launch/dryrun.py``). The dispatcher then sees every launch: a
``TorchDispatchMode`` can count its work (``roofline.analysis``) and a
selective-checkpoint policy can save its output (``remat="dots"``). A
tensor on any other device finds no implementation and raises.
"""
from __future__ import annotations

import torch


def kernel_op(name: str, schema: str, launch, plain, fake):
    """Register ``repro_torch::name`` with ``schema``: ``launch`` for CUDA
    tensors, ``plain`` for CPU tensors, ``fake`` for the output's shape.
    Returns the operator (callable)."""
    op = torch.library.custom_op(f"repro_torch::{name}", launch,
                                 mutates_args=(), device_types="cuda",
                                 schema=schema)
    op.register_kernel("cpu")(plain)
    op.register_fake(fake)
    return op
