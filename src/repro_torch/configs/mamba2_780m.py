"""Mamba-2 780M — attention-free SSM with SSD (state-space duality).

[arXiv:2405.21060] 48 layers, d_model 1536, expand 2 (d_inner 3072),
head_dim 64 (48 SSM heads), state dim 128, conv width 4, vocab 50280.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    head_dim=1,
    vocab_size=50_280,
    ssm_state_dim=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv_width=4,
    ssm_chunk=128,
    ssm_num_groups=1,
    tie_embeddings=True,
    pos_emb="none",
    citation="arXiv:2405.21060 (Mamba-2 / SSD)",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mamba2-reduced",
        family="ssm",
        num_layers=2,
        d_model=128,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        head_dim=1,
        vocab_size=512,
        ssm_state_dim=32,
        ssm_expand=2,
        ssm_head_dim=32,
        ssm_conv_width=4,
        ssm_chunk=32,
        tie_embeddings=True,
        pos_emb="none",
        citation=CONFIG.citation,
    )
