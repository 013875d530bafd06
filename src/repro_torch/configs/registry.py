"""Architecture registry: arch-id -> ModelConfig (counterpart of
``repro/configs/registry.py``). Only qwen1.5-0.5b is ported; the other nine
configs of the reference wait for their model families (ROADMAP.md,
"Remaining models")."""
from __future__ import annotations

from repro_torch.models.config import ModelConfig

ARCH_IDS = ("qwen1.5-0.5b",)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id == "qwen1.5-0.5b":
        from repro_torch.configs.qwen1_5_0_5b import CONFIG
        return CONFIG
    raise ValueError(f"unknown or not yet ported arch {arch_id!r}; the port "
                     f"has {list(ARCH_IDS)}")
