"""Config registry of the port: the paper's NLLB-600M.

The other architectures of the reference registry come with the slices
that port their model families.
"""

from . import nllb600m
from .base import (ModelConfig, MoECfg, ShapeSpec, SSMCfg, param_count,
                   reduce_config)

REGISTRY = {c.name: c for c in (nllb600m.CONFIG,)}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = ["get_config", "REGISTRY", "ModelConfig", "MoECfg", "SSMCfg",
           "ShapeSpec", "param_count", "reduce_config"]
