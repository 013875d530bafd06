"""Architecture registry: arch-id -> ModelConfig (counterpart of
``repro/configs/registry.py``). The dense family (qwen1.5-0.5b and -32b,
minitron-4b, stablelm-1.6b, musicgen-large, chameleon-34b), the MoE family
(deepseek-moe-16b), the SSM family (mamba2-370m) and the hybrid (zamba2-7b)
are ported; deepseek-v3-671b waits for the MLA and MTP blocks (ROADMAP.md,
A.11)."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "musicgen-large": "musicgen_large",
    "chameleon-34b": "chameleon_34b",
    "minitron-4b": "minitron_4b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "stablelm-1.6b": "stablelm_1_6b",
    "qwen1.5-32b": "qwen1_5_32b",
    "mamba2-370m": "mamba2_370m",
    "zamba2-7b": "zamba2_7b",
}
# the reference's other arch, refused until its blocks are ported
_WAITING = {"deepseek-v3-671b": "MLA and MTP"}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in _WAITING:
        raise ValueError(f"arch {arch_id!r} is not ported yet: its "
                         f"{_WAITING[arch_id]} blocks wait for ROADMAP.md "
                         f"A.11; the port has {list(ARCH_IDS)}")
    if arch_id not in _MODULES:
        raise ValueError(f"unknown arch {arch_id!r}; the port has "
                         f"{list(ARCH_IDS)}")
    return importlib.import_module(
        f"repro_torch.configs.{_MODULES[arch_id]}").CONFIG
