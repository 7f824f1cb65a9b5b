"""olmoe-1b-7b [moe] — 64 experts top-8 [arXiv:2409.02060; hf]."""
from .base import ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=1024, vocab_size=50304, mlp_act="silu_glu",
    rope_theta=1e4, norm_eps=1e-5,
    moe=MoECfg(num_experts=64, top_k=8),
    source="[arXiv:2409.02060; hf:allenai/OLMoE-1B-7B-0924]",
)
