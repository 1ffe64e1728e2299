"""Architecture registry: ``--arch <id>`` resolution for every entry point.

The data files are copies of the JAX package's, importing the port's own
``ModelConfig``; the input-shape tables are not part of the port yet.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

_MODULES: Dict[str, str] = {
    "qwen2-vl-7b": "qwen2_vl_7b",
    "qwen3-32b": "qwen3_32b",
    "granite-8b": "granite_8b",
    "whisper-small": "whisper_small",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "minicpm-2b": "minicpm_2b",
    "hymba-1.5b": "hymba_1_5b",
    "dbrx-132b": "dbrx_132b",
    "glm4-9b": "glm4_9b",
    "xlstm-1.3b": "xlstm_1_3b",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


__all__ = ["ARCH_IDS", "get_config"]
