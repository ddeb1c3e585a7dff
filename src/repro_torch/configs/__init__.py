"""Architecture registry: ``--arch <id>`` -> ArchConfig.

The dense family is registered whole; the other arch ids of the reference
registry raise ``NotImplementedError`` naming the ROADMAP item
that ports them, as does ``build_model`` for any family but ``dense``.
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
}
# The reference registry's other arch ids, ported with their families.
_NOT_PORTED = (
    "moonshot-v1-16b-a3b", "qwen2-moe-a2.7b", "mamba2-370m",
    "recurrentgemma-2b", "seamless-m4t-large-v2", "chameleon-34b",
)
_FAMILY_ITEM = ("ROADMAP.md queue A items 4-6 (the MoE, SSM/hybrid and "
                "encoder-decoder/VLM families)")

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
    """Instantiate the model for a config; only the dense family builds."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet: {_FAMILY_ITEM}")
    from repro_torch.models.lm import DecoderLM

    return DecoderLM(cfg, ctx)


__all__ = ["ARCH_IDS", "ArchConfig", "build_model", "get_config"]
