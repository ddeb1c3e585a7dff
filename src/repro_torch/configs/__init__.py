"""Architecture registry: ``--arch <id>`` -> ArchConfig.

The dense, MoE, SSM and hybrid families are registered whole; the other
arch ids of the reference registry raise ``NotImplementedError`` naming
the ROADMAP item that ports them, as does ``build_model`` for any other
family.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ArchConfig

_MODULES: Dict[str, str] = {
    "granite-8b": "repro_torch.configs.granite_8b",
    "minitron-8b": "repro_torch.configs.minitron_8b",
    "starcoder2-7b": "repro_torch.configs.starcoder2_7b",
    "qwen1.5-32b": "repro_torch.configs.qwen1p5_32b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2p7b",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
}
# The reference registry's other arch ids, ported with their families.
_NOT_PORTED = ("seamless-m4t-large-v2", "chameleon-34b")
_FAMILY_ITEM = ("ROADMAP.md queue A item 6 (the encoder-decoder and VLM "
                "families)")

ARCH_IDS: List[str] = list(_MODULES)


def get_config(name: str) -> ArchConfig:
    key = name.replace("_", "-")
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet: {_FAMILY_ITEM}")
    if key not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return importlib.import_module(_MODULES[key]).CONFIG


def build_model(cfg: ArchConfig, ctx=None):
    """Instantiate the model for a config; the dense, MoE, SSM and hybrid
    families build (``DecoderLM`` raises for the others)."""
    from repro_torch.models.lm import DecoderLM

    return DecoderLM(cfg, ctx)


__all__ = ["ARCH_IDS", "ArchConfig", "build_model", "get_config"]
