"""Architecture configs ported so far (``--arch <id>``).

Copies of ``repro.configs`` with the exact published dimensions.
``jet-mlp`` is the paper's own model, consumed by
``repro_torch.models.mlp`` (no serving family).  The other reference
architectures (yi, glm4, command-r, mamba2, deepseek-v2, olmoe,
llama-vision, zamba2) wait for their families (ROADMAP.md queue 1,
items 14, 15 and 17).
"""

from __future__ import annotations

import importlib

from ..models.config import ModelConfig

__all__ = ["get_config", "ARCH_IDS"]

ARCH_IDS = ["gemma-2b", "whisper-base", "jet-mlp"]

_MODULE_FOR = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULE_FOR:
        raise KeyError(f"arch {name!r} is not ported yet (have {ARCH_IDS}; "
                       f"see ROADMAP.md queue 1)")
    return importlib.import_module(f".{_MODULE_FOR[name]}", __package__).CONFIG

