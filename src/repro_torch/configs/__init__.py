"""Config registry of the port: the paper's NLLB-600M and the decoder-only
dense and VLM architectures of the reference registry.

The MoE, SSM, hybrid and audio architectures come with the slices that
port their model families.
"""

from . import (gemma3_1b, internlm2_20b, llava_next_mistral_7b, nemotron_4_15b,
               nllb600m, qwen2_5_14b)
from .base import (ModelConfig, MoECfg, ShapeSpec, SSMCfg, param_count,
                   reduce_config)

REGISTRY = {c.name: c for c in (nemotron_4_15b.CONFIG, internlm2_20b.CONFIG,
                                qwen2_5_14b.CONFIG, gemma3_1b.CONFIG,
                                llava_next_mistral_7b.CONFIG, nllb600m.CONFIG)}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = ["get_config", "REGISTRY", "ModelConfig", "MoECfg", "SSMCfg",
           "ShapeSpec", "param_count", "reduce_config"]
