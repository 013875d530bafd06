"""Architecture registry: arch-id -> ModelConfig, plus the serve shapes'
adjustments (counterpart of ``repro/configs/registry.py``). The port serves
all ten of the reference's configs: the dense family (qwen1.5-0.5b and -32b,
minitron-4b, stablelm-1.6b, musicgen-large, chameleon-34b), the MoE family
(deepseek-moe-16b, and deepseek-v3-671b with MLA and MTP), the SSM family
(mamba2-370m) and the hybrid (zamba2-7b)."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import INPUT_SHAPES, InputShape, ModelConfig

# in the reference's order, so that ARCH_IDS is its tuple
_MODULES = {
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "mamba2-370m": "mamba2_370m",
    "musicgen-large": "musicgen_large",
    "chameleon-34b": "chameleon_34b",
    "minitron-4b": "minitron_4b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "zamba2-7b": "zamba2_7b",
    "stablelm-1.6b": "stablelm_1_6b",
    "qwen1.5-32b": "qwen1_5_32b",
}

ARCH_IDS = tuple(_MODULES)

# the sliding window attention archs use for long_500k
LONG_CONTEXT_WINDOW = 4096


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise ValueError(f"unknown arch {arch_id!r}; the port has "
                         f"{list(ARCH_IDS)}")
    return importlib.import_module(
        f"repro_torch.configs.{_MODULES[arch_id]}").CONFIG


def uses_attention(cfg: ModelConfig) -> bool:
    return cfg.family != "ssm"


def for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Shape-specific adjustments: long_500k on an attention arch runs the
    sliding window of ``LONG_CONTEXT_WINDOW``."""
    if shape.name == "long_500k" and uses_attention(cfg):
        return dataclasses.replace(cfg, sliding_window=LONG_CONTEXT_WINDOW)
    return cfg


def cache_len(cfg: ModelConfig, shape: InputShape) -> int:
    """KV-cache length for a decode shape: the window under a sliding
    window (a ring buffer), else the shape's sequence length."""
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, shape.seq_len)
    return shape.seq_len


def shape_by_name(name: str) -> InputShape:
    return INPUT_SHAPES[name]
