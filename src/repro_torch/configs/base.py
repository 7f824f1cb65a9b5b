"""Model configuration dataclasses, the batch-shape spec, the smoke-size
reduction and the analytic parameter count."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["MoECfg", "SSMCfg", "ModelConfig", "RankConfig", "ShapeSpec", "reduce_config",
           "param_count"]


@dataclasses.dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    parallel_mode: str = "expert"
    aux_loss_weight: float = 0.01
    dispatch_groups: int = 0


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                          # dense|moe|ssm|hybrid|vlm|audio|encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    mlp_act: str = "silu_glu"
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    window_pattern: Tuple[int, ...] = ()
    tie_embeddings: bool = False
    embed_scale: bool = False
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    enc_layers: int = 0
    enc_len: int = 0
    d_rec: int = 0
    local_window: int = 0
    num_patches: int = 0
    source: str = ""


@dataclasses.dataclass(frozen=True)
class RankConfig(ModelConfig):
    """One rank's config on a tensor-parallel group of ``tp`` ranks
    (``parallel.tp.local_config``): the rank-local widths of every
    sublayer that splits over the group, and ``replicated``, the sublayer
    kinds the rank holds whole ("attn", "ffn", "rec" for the RG-LRU,
    "ssd" for the SSM), which run one device's code with no collective."""
    tp: int = 1
    replicated: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                            # train | prefill | decode


def reduce_config(cfg: ModelConfig, **over) -> ModelConfig:
    """Smoke-test variant: same family/topology, tiny dims."""
    heads = 4
    kv = max(1, min(cfg.num_kv_heads * heads // max(cfg.num_heads, 1), heads))
    layers = 4 if cfg.family == "hybrid" else 2
    changes = dict(
        name=cfg.name + "-smoke",
        num_layers=layers,
        d_model=64,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 96,
        vocab_size=256,
        enc_layers=2 if cfg.enc_layers else 0,
        enc_len=12 if cfg.enc_len else 0,
        d_rec=64 if cfg.d_rec else 0,
        local_window=8 if cfg.local_window else 0,
        num_patches=4 if cfg.num_patches else 0,
        window_pattern=tuple(min(w, 8) for w in cfg.window_pattern),
        moe=None if cfg.moe is None else dataclasses.replace(
            cfg.moe, num_experts=4, top_k=2),
        ssm=None if cfg.ssm is None else SSMCfg(state_dim=16, head_dim=16,
                                                expand=2, chunk=8),
    )
    changes.update(over)
    return dataclasses.replace(cfg, **changes)


def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count (the reference's formula)."""
    d, hd = cfg.d_model, cfg.head_dim
    H, Hkv, V, ff = cfg.num_heads, cfg.num_kv_heads, cfg.vocab_size, cfg.d_ff
    embed = V * d * (1 if cfg.tie_embeddings else 2)

    def attn():
        return d * H * hd * 2 + d * Hkv * hd * 2

    def ffn(width):
        mult = 3 if cfg.mlp_act.endswith("_glu") else 2
        return mult * d * width

    if cfg.family == "ssm":
        d_inner = cfg.ssm.expand * d
        nh = d_inner // cfg.ssm.head_dim
        per = d * (2 * d_inner + 2 * cfg.ssm.state_dim + nh) + d_inner * d
        return embed + cfg.num_layers * per

    if cfg.family == "hybrid":
        n_super = cfg.num_layers // 3
        tail = cfg.num_layers - 3 * n_super
        rec = (2 * d * cfg.d_rec + 2 * cfg.d_rec ** 2 + cfg.d_rec * d
               + ffn(ff))
        at = attn() + ffn(ff)
        return embed + (2 * n_super + tail) * rec + n_super * at

    if cfg.moe is not None:
        per = attn() + d * cfg.moe.num_experts + cfg.moe.num_experts * ffn(ff)
        dec = cfg.num_layers * per
        if cfg.enc_layers:
            dec += cfg.enc_layers * (attn() + ffn(ff))
        return embed + dec

    per = attn() + ffn(ff)
    total = embed + cfg.num_layers * per
    if cfg.enc_layers:
        total += cfg.enc_layers * (attn() + ffn(ff))
        total += cfg.num_layers * attn()      # decoder cross-attention
    return total
