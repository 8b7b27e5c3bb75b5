"""Llama-4 Scout 17B-active / 16 experts — MoE with early fusion.

[hf:meta-llama/Llama-4-Scout-17B-16E] 48 layers, d_model 5120, 40 heads
(GQA kv=8, head_dim 128), expert d_ff 8192, vocab 202048, 16 routed experts
top-1 + 1 shared expert per MoE layer; natively multimodal (early fusion) —
handled here via the VLM-style patch-embedding input path.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,  # dense-layer hidden (first_k_dense)
    vocab_size=202_048,
    num_experts=16,
    num_shared_experts=1,
    experts_per_token=1,
    moe_d_ff=8192,
    first_k_dense=0,
    fsdp=True,
    remat=True,
    citation="hf:meta-llama/Llama-4-Scout-17B-16E",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-reduced",
        family="moe",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        num_experts=4,
        num_shared_experts=1,
        experts_per_token=1,
        moe_d_ff=256,
        citation=CONFIG.citation,
    )
