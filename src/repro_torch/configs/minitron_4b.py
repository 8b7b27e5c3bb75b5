"""Minitron-4B — pruned Nemotron-4 (squared-ReLU MLP).

[arXiv:2407.14679] 32 layers, d_model 3072, 24 heads (GQA kv=8, head_dim 128),
d_ff 9216, vocab 256000; squared-ReLU MLP per the Nemotron family.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256_000,
    mlp_act="relu2",
    fsdp=True,
    citation="arXiv:2407.14679 (Minitron / Nemotron pruning)",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="minitron-reduced",
        family="dense",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        mlp_act="relu2",
        citation=CONFIG.citation,
    )
