"""recurrentgemma-9b [hybrid] — RG-LRU + local attention 2:1
[arXiv:2402.19427]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1, head_dim=256,
    d_ff=12288, vocab_size=256000, mlp_act="gelu_glu",
    rope_theta=1e4, norm_eps=1e-6,
    tie_embeddings=True, embed_scale=True,
    d_rec=4096, local_window=2048,
    source="[arXiv:2402.19427; assignment line]",
)
