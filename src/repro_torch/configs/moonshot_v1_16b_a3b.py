"""moonshot-v1-16b-a3b [moe] — 64 experts top-6, GQA kv=16
[hf:moonshotai/Moonlight-16B-A3B]."""
from .base import ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=163840, mlp_act="silu_glu",
    rope_theta=5e4, norm_eps=1e-5,
    moe=MoECfg(num_experts=64, top_k=6),
    source="[hf:moonshotai/Moonlight-16B-A3B; assignment line]",
)
