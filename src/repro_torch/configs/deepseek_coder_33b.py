"""DeepSeek-Coder 33B — llama-architecture dense decoder (GQA).

[arXiv:2401.14196] 62 layers, d_model 7168, 56 heads (GQA kv=8, head_dim 128),
d_ff 19200, vocab 32256.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32_256,
    fsdp=True,
    remat=True,
    citation="arXiv:2401.14196 (DeepSeek-Coder)",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-reduced",
        family="dense",
        num_layers=2,
        d_model=128,
        num_heads=8,
        num_kv_heads=2,
        head_dim=16,
        d_ff=256,
        vocab_size=512,
        citation=CONFIG.citation,
    )
