"""Config registry of the port: the paper's NLLB-600M and its MoE variant,
and the SSM, dense, MoE, VLM, audio and hybrid architectures of the
reference registry, in the reference's order.
"""

from . import (gemma3_1b, internlm2_20b, llava_next_mistral_7b, mamba2_780m,
               moonshot_v1_16b_a3b, nemotron_4_15b, nllb600m, olmoe_1b_7b,
               qwen2_5_14b, recurrentgemma_9b, whisper_base)
from .base import (ModelConfig, MoECfg, RankConfig, ShapeSpec, SSMCfg, param_count,
                   reduce_config)

REGISTRY = {c.name: c for c in (mamba2_780m.CONFIG, nemotron_4_15b.CONFIG,
                                internlm2_20b.CONFIG, qwen2_5_14b.CONFIG,
                                gemma3_1b.CONFIG, moonshot_v1_16b_a3b.CONFIG,
                                olmoe_1b_7b.CONFIG, llava_next_mistral_7b.CONFIG,
                                whisper_base.CONFIG, recurrentgemma_9b.CONFIG,
                                nllb600m.CONFIG, nllb600m.CONFIG_MOE)}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = ["get_config", "REGISTRY", "ModelConfig", "MoECfg", "RankConfig", "SSMCfg",
           "ShapeSpec", "param_count", "reduce_config"]
