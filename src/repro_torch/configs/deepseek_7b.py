"""DeepSeek-LLM 7B — llama-architecture dense decoder.

[arXiv:2401.02954] 30 layers, d_model 4096, 32 heads (kv=32, head_dim 128),
d_ff 11008, vocab 102400.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=102_400,
    fsdp=True,
    remat=True,
    citation="arXiv:2401.02954 (DeepSeek LLM)",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b-reduced",
        family="dense",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        citation=CONFIG.citation,
    )
