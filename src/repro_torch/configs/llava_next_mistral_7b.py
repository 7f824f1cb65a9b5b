"""llava-next-mistral-7b [vlm] — mistral-7B backbone, anyres tiling via a
STUB frontend (the caller provides precomputed patch embeddings,
``img_embeds``)
[hf:llava-hf/llava-v1.6-mistral-7b-hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000, mlp_act="silu_glu",
    rope_theta=1e6, norm_eps=1e-5,
    window_pattern=(4096,),               # mistral sliding window
    num_patches=576,
    source="[hf:llava-hf/llava-v1.6-mistral-7b-hf; assignment line]",
)
