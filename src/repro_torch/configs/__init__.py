"""Architecture registry: ``get_config("yi-34b")`` etc.

The ten assigned architectures plus the paper's own benchmark model
(llama32-3b). ``reduce_for_smoke`` produces the CPU-testable reduced config
of the same family.
"""
from __future__ import annotations

from typing import Dict, List

from .base import (EncDecConfig, HybridConfig, ModelConfig, MoEConfig,
                   RWKVConfig, SSMConfig, VisionStubConfig, reduce_for_smoke)
from .shapes import (ALL_SHAPES, DECODE_32K, LONG_500K, PREFILL_32K, SHAPES,
                     TRAIN_4K, InputShape, applicable, skip_reason)

from . import (command_r_35b, deepseek_moe_16b, internvl2_2b, llama32_3b,
               moonshot_v1_16b_a3b, qwen2_0_5b, qwen3_1_7b, rwkv6_3b,
               seamless_m4t_medium, yi_34b, zamba2_2_7b)

_MODULES = [
    yi_34b, qwen3_1_7b, command_r_35b, qwen2_0_5b, zamba2_2_7b, rwkv6_3b,
    internvl2_2b, seamless_m4t_medium, moonshot_v1_16b_a3b, deepseek_moe_16b,
    llama32_3b,
]

REGISTRY: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}

ASSIGNED_ARCHS: List[str] = [
    "yi-34b", "qwen3-1.7b", "command-r-35b", "qwen2-0.5b", "zamba2-2.7b",
    "rwkv6-3b", "internvl2-2b", "seamless-m4t-medium", "moonshot-v1-16b-a3b",
    "deepseek-moe-16b",
]


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def list_archs() -> List[str]:
    return list(REGISTRY)


__all__ = [
    "ModelConfig", "MoEConfig", "SSMConfig", "RWKVConfig", "HybridConfig",
    "EncDecConfig", "VisionStubConfig", "InputShape", "REGISTRY",
    "ASSIGNED_ARCHS", "ALL_SHAPES", "SHAPES", "TRAIN_4K", "PREFILL_32K",
    "DECODE_32K", "LONG_500K", "get_config", "list_archs", "applicable",
    "skip_reason", "reduce_for_smoke",
]
