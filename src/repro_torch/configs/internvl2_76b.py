"""InternVL2-76B — VLM; language backbone (Llama-3-70B class) + stub ViT.

[arXiv:2404.16821] Backbone: 80 layers, d_model 8192, 64 heads (GQA kv=8,
head_dim 128), d_ff 28672, vocab 128256.  The InternViT-6B vision encoder +
MLP projector is the allowed STUB: ``input_specs`` supplies precomputed patch
embeddings (num_image_tokens x d_model) that early-fuse with text tokens.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128_256,
    num_image_tokens=1024,
    fsdp=True,
    remat=True,
    citation="arXiv:2404.16821 (InternVL2)",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="internvl2-reduced",
        family="vlm",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        num_image_tokens=16,
        citation=CONFIG.citation,
    )
