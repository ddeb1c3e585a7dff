"""Architecture registry: ``--arch <id>`` -> ArchConfig. Every arch id of
the reference registry is registered; ``build_model`` builds the
encoder-decoder family as ``EncDecModel`` and every other family as
``DecoderLM``."""
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
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
    "chameleon-34b": "repro_torch.configs.chameleon_34b",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(name: str) -> ArchConfig:
    key = name.replace("_", "-")
    if key not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return importlib.import_module(_MODULES[key]).CONFIG


def build_model(cfg: ArchConfig, ctx=None):
    """Instantiate the right model family for a config."""
    if cfg.family == "encdec":
        from repro_torch.models.encdec import EncDecModel

        return EncDecModel(cfg, ctx)
    from repro_torch.models.lm import DecoderLM

    return DecoderLM(cfg, ctx)


__all__ = ["ARCH_IDS", "ArchConfig", "build_model", "get_config"]
