"""mamba2-780m [ssm] — SSD, attention-free [arXiv:2405.21060]."""
from .base import ModelConfig, SSMCfg

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, num_heads=48, num_kv_heads=48, head_dim=64,
    d_ff=0, vocab_size=50280, mlp_act="silu",
    tie_embeddings=True, norm_eps=1e-5,
    ssm=SSMCfg(state_dim=128, head_dim=64, expand=2, chunk=128),
    source="[arXiv:2405.21060; assignment line]",
)
