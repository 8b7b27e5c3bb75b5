"""RecurrentGemma-2B — hybrid RG-LRU + local attention, 1 attn : 2 recurrent.

[arXiv:2402.19427] Griffin/RecurrentGemma: 26 layers, d_model 2560, 10 heads
(MQA, kv=1, head_dim 256), GeGLU d_ff 7680, vocab 256000, local-attention
window 2048, RG-LRU recurrence width 2560.
"""
from repro_torch.configs.base import ModelConfig

_PATTERN = tuple("local_attn" if i % 3 == 2 else "rglru" for i in range(26))

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    mlp_act="swiglu",
    attention_window=2048,
    block_pattern=_PATTERN,
    rglru_width=2560,
    tie_embeddings=True,
    citation="arXiv:2402.19427 (RecurrentGemma / Griffin)",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b-reduced",
        family="hybrid",
        num_layers=3,
        d_model=128,
        num_heads=4,
        num_kv_heads=1,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        mlp_act="swiglu",
        attention_window=64,
        block_pattern=("rglru", "rglru", "local_attn"),
        rglru_width=128,
        tie_embeddings=True,
        citation=CONFIG.citation,
    )
