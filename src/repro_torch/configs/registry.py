"""Architecture registry: ``--arch <id>`` resolution (the port of
``repro.configs.registry``; the arch files are copies)."""
from __future__ import annotations

from typing import Callable, Dict

from ..models.config import ModelConfig
from . import (
    granite_3_8b,
    grok_1_314b,
    hymba_1_5b,
    minicpm3_4b,
    musicgen_large,
    olmoe_1b_7b,
    phi_3_vision_4_2b,
    qwen3_14b,
    rwkv6_1_6b,
    starcoder2_3b,
)

_MODULES = {
    "granite-3-8b": granite_3_8b,
    "starcoder2-3b": starcoder2_3b,
    "qwen3-14b": qwen3_14b,
    "minicpm3-4b": minicpm3_4b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "grok-1-314b": grok_1_314b,
    "phi-3-vision-4.2b": phi_3_vision_4_2b,
    "hymba-1.5b": hymba_1_5b,
    "musicgen-large": musicgen_large,
    "rwkv6-1.6b": rwkv6_1_6b,
}

ARCH_NAMES = list(_MODULES.keys())


def get_config(name: str) -> ModelConfig:
    return _MODULES[name].CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _MODULES[name].smoke_config()


def all_configs() -> Dict[str, ModelConfig]:
    return {k: m.CONFIG for k, m in _MODULES.items()}
