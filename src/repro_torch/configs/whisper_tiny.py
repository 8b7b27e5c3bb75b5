"""Whisper-tiny — encoder-decoder audio backbone (conv/mel frontend stubbed).

[arXiv:2212.04356] 4+4 layers, d_model 384, 6 heads (kv=6, head_dim 64),
d_ff 1536, vocab 51865, GELU MLP, LayerNorm, learned decoder positions.
The mel-spectrogram + conv feature extractor is the allowed STUB:
``input_specs`` supplies precomputed frame embeddings (encoder_seq x d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51_865,
    mlp_act="gelu",
    norm="layernorm",
    pos_emb="learned",
    is_encoder_decoder=True,
    num_encoder_layers=4,
    encoder_seq=1500,
    tie_embeddings=True,
    citation="arXiv:2212.04356 (Whisper)",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="whisper-reduced",
        family="audio",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        mlp_act="gelu",
        norm="layernorm",
        pos_emb="learned",
        is_encoder_decoder=True,
        num_encoder_layers=2,
        encoder_seq=64,
        tie_embeddings=True,
        citation=CONFIG.citation,
    )
