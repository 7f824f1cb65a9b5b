"""NLLB-200 600M distilled (the paper's model, arXiv:2207.04672).

Six-layer pre-norm encoder and decoder, MHA, two-layer ReLU FFNs, a
tied 256k-token embedding, many-to-many translation driven by
target-language code tokens. The -moe variant (the paper's Fig. 3b) swaps
every FFN for 16 top-2 experts.
"""
from .base import ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="nllb600m", family="encdec",
    num_layers=6, enc_layers=6, enc_len=256,
    d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=8192, vocab_size=256204, mlp_act="relu",
    tie_embeddings=True, norm_eps=1e-5,
    source="[Nature 2024 / arXiv:2207.04672; paper II-A]",
)

CONFIG_MOE = ModelConfig(
    name="nllb600m-moe", family="encdec",
    num_layers=6, enc_layers=6, enc_len=256,
    d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=8192, vocab_size=256204, mlp_act="relu",
    tie_embeddings=True, norm_eps=1e-5,
    moe=MoECfg(num_experts=16, top_k=2),
    source="[paper Fig. 3b MoE variant]",
)
