"""Architecture configs ported so far (``--arch <id>``).

Copies of ``repro.configs`` with the exact published dimensions: the
whole ``lm`` family (gemma-2b, yi-6b, glm4-9b, command-r-35b, and the
MoE configs olmoe-1b-7b and deepseek-v2-236b, the latter with MLA),
the recurrent families (mamba2-370m, ``ssm``; zamba2-1.2b, ``hybrid``),
whisper-base (``encdec``), llama-3.2-vision-11b (``vlm``) and
``jet-mlp``, the paper's own model, consumed by
``repro_torch.models.mlp`` (no serving family).  Every config of the
reference is ported.
"""

from __future__ import annotations

import importlib

from ..models.config import ModelConfig

__all__ = ["get_config", "ARCH_IDS"]

ARCH_IDS = ["gemma-2b", "yi-6b", "glm4-9b", "command-r-35b", "olmoe-1b-7b",
            "deepseek-v2-236b", "mamba2-370m", "zamba2-1.2b", "whisper-base",
            "llama-3.2-vision-11b", "jet-mlp"]

_MODULE_FOR = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULE_FOR:
        raise KeyError(f"arch {name!r} is not ported yet (have {ARCH_IDS}; "
                       f"see ROADMAP.md queue 1)")
    return importlib.import_module(f".{_MODULE_FOR[name]}", __package__).CONFIG
