"""whisper-base [audio] — the enc-dec backbone; the conv frontend is a
stub: the encoder takes precomputed frame embeddings [arXiv:2212.04356]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    num_layers=6, enc_layers=6, enc_len=1500,
    d_model=512, num_heads=8, num_kv_heads=8, head_dim=64,
    d_ff=2048, vocab_size=51865, mlp_act="gelu",
    tie_embeddings=True, norm_eps=1e-5,
    source="[arXiv:2212.04356; assignment line]",
)
