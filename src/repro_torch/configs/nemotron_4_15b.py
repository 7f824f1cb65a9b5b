"""nemotron-4-15b [dense] — GQA kv=8, squared-ReLU [arXiv:2402.16819]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense",
    num_layers=32, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=256000, mlp_act="squared_relu",
    rope_theta=1e4, norm_eps=1e-5,
    source="[arXiv:2402.16819; assignment line]",
)
