"""Qwen2-1.5B — dense GQA decoder with QKV bias.

[arXiv:2407.10671] 28 layers, d_model 1536, 12 heads (GQA kv=2, head_dim 128),
d_ff 8960, vocab 151936, QKV bias, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151_936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    citation="arXiv:2407.10671 (Qwen2)",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-reduced",
        family="dense",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        qkv_bias=True,
        tie_embeddings=True,
        citation=CONFIG.citation,
    )
