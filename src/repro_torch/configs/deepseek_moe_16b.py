"""DeepSeekMoE-16B — fine-grained experts: 2 shared + 64 routed, top-6.

[arXiv:2401.06066] 28 layers, d_model 2048, 16 heads (kv=16, head_dim 128),
per-expert d_ff 1408, vocab 102400; layer 0 uses a dense MLP (d_ff 10944).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=10944,  # dense layer 0 hidden dim
    vocab_size=102_400,
    num_experts=64,
    num_shared_experts=2,
    experts_per_token=6,
    moe_d_ff=1408,
    first_k_dense=1,
    fsdp=True,
    remat=True,
    citation="arXiv:2401.06066 (DeepSeekMoE)",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-reduced",
        family="moe",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        num_experts=4,
        num_shared_experts=1,
        experts_per_token=2,
        moe_d_ff=64,
        first_k_dense=1,
        citation=CONFIG.citation,
    )
