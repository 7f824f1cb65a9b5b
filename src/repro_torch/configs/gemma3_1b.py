"""gemma3-1b [dense] — 5:1 local:global (window 512), GQA kv=1, 128k ctx
[hf:google/gemma-3-1b-pt]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    num_layers=26, d_model=1152, num_heads=4, num_kv_heads=1, head_dim=256,
    d_ff=6912, vocab_size=262144, mlp_act="gelu_glu", qk_norm=True,
    rope_theta=1e6, norm_eps=1e-6,
    window_pattern=(512, 512, 512, 512, 512, 0),   # 5 local : 1 global
    tie_embeddings=True, embed_scale=True,
    source="[hf:google/gemma-3-1b-pt; assignment line]",
)
